"""The plain reference: exact cosine top-k in float32 with TF32 off and
the comparison that decides `correct` (knn.py), and the truth recall's
arithmetic (recall.py). Plain PyTorch and NumPy; nothing here imports the
program under test or JAX."""
