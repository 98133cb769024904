"""The yardstick's arithmetic: the card's peaks, each kernel's operations
and bytes per launch (one file per kernel), and the model's useful FLOPs.
Shapes come from the configuration file and the benchmark's own length
bookkeeping, never from the kernels' code."""
