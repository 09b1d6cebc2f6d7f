"""LB-front-door serving engine (``engine.py``)."""
