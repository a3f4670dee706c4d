"""PyTorch/CUDA port of the device-aware federated-learning system.

A second package beside the JAX reference ``repro``: the paper's
synchronous round on SynthFEMNIST and its hostile variant (byzantine
fleets, attacks, trimmed-mean and Krum commits), run through
:class:`repro_torch.federated.simulation.FederatedSimulation`, with the
server's reductions (the weighted commit, the Md divergence, the
trimmed mean and Krum's pairwise distances) as hand-written CUDA
kernels for Hopper (``repro_torch/kernels/csrc``).  The package imports neither ``jax`` nor
``repro``; its entry points run on the GPU unless the caller passes
``device="cpu"``.
"""
