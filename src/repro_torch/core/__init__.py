"""The card's hardware constants and machine hierarchy (`mesh.py`), the
interconnect models (`interconnect.py`: MemPool's Top_1 / Top_4 / Top_H
and the collective cost model), the address scrambler and the
addressing plan (`addressing.py`) and the sharded train step's counted
collectives (`collectives.py`)."""
