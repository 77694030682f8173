"""Hardware constants of the card the port runs on (`mesh.py`)."""
