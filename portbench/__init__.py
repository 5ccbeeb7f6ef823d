"""The benchmark of the PyTorch and CUDA port of RoITr (`roitr_torch`).

`python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell once and prints one JSON result line.
"""
