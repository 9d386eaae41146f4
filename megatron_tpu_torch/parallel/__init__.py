"""The (dp, tp) mesh on torch.distributed: the mesh and its process groups
(mesh.py), process start-up and the global batch (multihost.py), the
hand-written collectives and their autograd mappings (collectives.py) and
the sharding rules and leaf layout (sharding.py)."""
