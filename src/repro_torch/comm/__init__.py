"""Wire formats and transport for FedCAMS messages (counterpart of
``repro.comm``): ``wire`` (packed byte codecs), ``transport`` (the
simulated network) and ``metrics`` (``CommLog``)."""
