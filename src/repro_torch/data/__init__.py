"""SynthFEMNIST, the numpy dataset the port shares with the reference."""
