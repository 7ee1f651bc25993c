"""DP mechanics of the port: the accountant, clipping and noise, ghost
clipping for dense decoder stacks, and the facilitator schedule."""
