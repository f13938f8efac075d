"""MPS engine and the backend layer over it."""
