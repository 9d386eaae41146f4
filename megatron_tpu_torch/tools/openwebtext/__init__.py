"""The corpus-cleaning suite (the port's own copy of the root
tools/openwebtext/, stdlib and numpy only)."""
