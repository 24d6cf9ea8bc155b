"""Launch helpers: the device mesh."""
