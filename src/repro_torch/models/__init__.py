"""The LM stack of the port, dense family: config, parameter declarations,
layers, attention (K6 on the blockwise route), the model, the serving
path (prefill, decode) and the carrier of the JAX package's weights."""
