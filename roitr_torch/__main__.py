"""python -m roitr_torch <config.yaml> [--mode train|val|test] [--device cuda|cpu]"""

from roitr_torch.main import main

if __name__ == "__main__":
    main()
