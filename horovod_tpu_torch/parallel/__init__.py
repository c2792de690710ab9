"""Parallelism beyond data parallelism: meshes of ranks, the
differentiable collectives on their axes, sequence parallelism and the
GPipe pipeline."""
