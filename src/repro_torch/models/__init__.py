"""The model zoo's decoder-only LMs (attention, Mamba2), as torch modules."""
