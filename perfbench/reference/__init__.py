"""Plain references, one per kind of cell: plain PyTorch in float32 with
TF32 off, importing nothing of the program."""
