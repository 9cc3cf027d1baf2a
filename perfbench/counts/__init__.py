"""The benchmark's yardstick, frozen: the kernels' operations and bytes,
the card's peaks, the kernel categories and the model FLOPs of a step.
The program may change; these do not."""
