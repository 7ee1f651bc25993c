"""Model code of the port: layers, attention and the decoder stack."""
