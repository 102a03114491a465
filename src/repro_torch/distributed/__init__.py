"""The single-process device mesh, its collectives and elastic re-placement."""
