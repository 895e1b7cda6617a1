"""`python -m var_tpu_torch.rl`: see var_tpu_torch/rl/__init__.py."""
from var_tpu_torch.rl import main

if __name__ == "__main__":
    main()
