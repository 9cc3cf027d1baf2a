"""Plain PyTorch references of the model families, one file a family
(``<family>.py``), in float32. They import nothing of the program."""
