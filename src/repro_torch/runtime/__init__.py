"""Serving runtime of the port (``repro/runtime``): the batched ``Engine``
with PERKS persistent decode (``server.py``)."""
