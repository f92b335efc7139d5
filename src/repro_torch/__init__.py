"""PyTorch/CUDA port of ``repro`` for one NVIDIA H100.

The package mirrors ``repro``'s layout (``core/``, ``data/``, ``models/``,
``fl/``, ``kernels/``) and imports ``torch`` and numpy only.  Entry points
take an explicit ``device=``: ``None`` means the card, and a missing GPU
raises instead of falling back to the CPU; the tests pass
``device="cpu"``.  The port runs on one device: the reference's mesh and
sharding arguments are accepted where its signatures have them and
either are no-ops on one device or raise.
"""
