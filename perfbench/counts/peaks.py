"""The table of peaks (``peaks.json``): what a roofline share or an
``mfu`` divides by, for the card a run names."""
from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

_TABLE = json.loads((Path(__file__).with_name("peaks.json")).read_text())


def device_peaks(kind: str) -> Optional[dict]:
    """The peaks of the card ``kind`` (``torch.cuda.get_device_name()``),
    or None for a card the table does not hold."""
    return _TABLE["devices"].get(kind)
