"""Pack formats, pruning and the sparse linear layer of the port."""
