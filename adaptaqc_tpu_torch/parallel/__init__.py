"""Multi-device sharding (the JAX package's `parallel/`) on
torch.distributed: `mesh` holds the launcher, the device mesh and the
sharding functions; `sv_sharded` and `mps_sharded` the engines written out
over it."""
