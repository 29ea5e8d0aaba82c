"""Device meshes for the erasure data plane (``parallel/mesh.py``)."""
