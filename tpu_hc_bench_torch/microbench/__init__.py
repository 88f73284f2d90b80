"""Collective micro-benchmarks of the port: the OSU sweeps over
``torch.distributed`` (``osu.py``)."""
