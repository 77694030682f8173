"""Launch side of the port: the roofline model (`roofline.py`), the
production and test meshes (`mesh.py`) and the training launcher
(`train.py`)."""
