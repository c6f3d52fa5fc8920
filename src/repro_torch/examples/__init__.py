"""Ports of the top-level ``examples/``: each runs on the card unless
given ``--device cpu``; each ``main`` takes its sizes as arguments, so a
test can run it small."""
