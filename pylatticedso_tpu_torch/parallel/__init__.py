"""Structured stencil operator and its multigrid preconditioner."""
