"""The card's hardware constants and machine hierarchy (`mesh.py`) and the
interconnect models (`interconnect.py`: MemPool's Top_1 / Top_4 / Top_H
and the collective cost model)."""
