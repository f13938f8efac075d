"""Host helpers: constants, ansatz blocks, pair gradients, compression,
synthetic targets."""
