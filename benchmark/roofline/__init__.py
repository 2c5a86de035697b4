"""The least time each hand-written kernel could take at the shapes it was
given: the bytes it must move over the card's memory bandwidth, or its
operations over the float32 peak, whichever is larger.  One file per
kernel; the arithmetic is the kernel table's (``chip_smoke.py``)."""
