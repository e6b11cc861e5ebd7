from repro_torch.utils.tree import tree_bytes, tree_count, tree_equal, tree_hash
