"""Models in the reference state_dict layout, and the kernel serving path."""
