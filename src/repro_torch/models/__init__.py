"""The LM model family of the port: layers, mixers (attention, MoE, Mamba,
xLSTM) and the unified model (port of the JAX package's ``models/``)."""
