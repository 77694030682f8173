"""Launch-side models of the port (`roofline.py`)."""
