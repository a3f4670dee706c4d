"""The round engine: draws, selection, the sync strategy, the simulation."""
