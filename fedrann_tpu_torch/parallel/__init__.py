"""Multi-device and multi-process runs: the device mesh of one process
(mesh.py), the fused sharded step (step.py), the process group and its
transports (dist.py) and the multi-process runtime (runtime.py). The
sharded k-NN is knn/ring.py."""
