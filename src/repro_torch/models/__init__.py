"""LM scaffolding of the port: layers, attention, Mamba2, the family
stacks and the top-level model (inference only)."""
