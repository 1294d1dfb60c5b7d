"""SVM training and prediction on precomputed kernels (numpy)."""
