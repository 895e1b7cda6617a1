"""Pretext entry point: collect triplets and/or train the VAR.

    python -m var_tpu_torch.pretext --env arms [--device cpu] --set KNOB=VALUE ...

Behaviour is selected by the profile's booleans (pretextCollection,
pretextTrain, ...), as in the JAX package's pretext.py.
"""
from var_tpu_torch.cli import build_config, parse_args
from var_tpu_torch.train.pretext import PretextTrainer


def main(argv=None):
    args = parse_args(argv, description=__doc__)
    config = build_config(args, role="pretext")
    trainer = PretextTrainer(config, device=args.device)
    trainer.run()
    return trainer


if __name__ == "__main__":
    main()
