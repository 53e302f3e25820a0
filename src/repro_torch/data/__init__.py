"""Data: the seeded synthetic-token pipeline (``pipeline``, the reference's
own, numpy only) and the reference files the card checks hold the port to
(``*.json``, built by ``tests/_torch_reference.py``)."""
