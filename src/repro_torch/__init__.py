"""PyTorch/CUDA port of the device-aware federated-learning system.

A second package beside the JAX reference ``repro``: the paper's
synchronous round on SynthFEMNIST, run through
:class:`repro_torch.federated.simulation.FederatedSimulation`, with the
server's two streaming reductions (the weighted commit and the Md
divergence) as hand-written CUDA kernels for Hopper
(``repro_torch/kernels/csrc``).  The package imports neither ``jax`` nor
``repro``; its entry points run on the GPU unless the caller passes
``device="cpu"``.
"""
