"""Multi-device runs inside one process: the device mesh (mesh.py) and the
fused sharded step (step.py). The sharded k-NN is knn/ring.py."""
