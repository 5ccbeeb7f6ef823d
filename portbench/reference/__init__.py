"""RoITr in plain PyTorch, fp32: the equations the benchmark judges the
program's outputs by. Imports nothing of the program."""
