"""The benchmark's plain reference: a frozen bloomRF (``bloomrf.py``) and
the exact answers of the sorted keys (``truth.py``).  Plain torch; it
imports nothing of the program under test."""
