"""The plain reference the benchmark judges the program by: plain PyTorch,
written from the published methods, importing nothing of the program."""
