"""Process groups, pair meshes and multi-process bootstrap (torch.distributed)."""
