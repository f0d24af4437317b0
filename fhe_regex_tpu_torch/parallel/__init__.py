"""Multi-GPU execution over ``torch.distributed``: one process per card.

``mesh.py`` shards each level's bootstrap batch over a 1-D
``DeviceMesh``; ``collective.py`` ORs one encrypted bit per rank across the
mesh; ``multihost.py`` opens the process group (NCCL on CUDA, gloo on the
CPU); ``tensor.py`` shards the rows of the external product inside one
bootstrap; ``dryrun.py`` drives all of them once.
"""
