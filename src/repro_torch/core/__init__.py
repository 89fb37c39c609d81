"""Table core: key representation, policies, state, locate, merge, ops, handle."""
