"""The reference's physics: plain narrow phase, Jacobi engine and the
plain versions of the two kernels (``plain.py``)."""
