"""Pretext entry point: collect triplets and/or train the VAR.

    python -m var_tpu_torch.pretext --env arms [--device cpu] --set KNOB=VALUE ...

Behaviour is selected by the profile's booleans (pretextCollection,
pretextTrain, ...), as in the JAX package's pretext.py. With meshShape
set, training runs on its ranks (cli.py::sharded_main): rank 0 collects,
every rank trains its block of each batch, rank 0 writes the files.
"""
from var_tpu_torch.cli import build_config, parse_args, sharded_main
from var_tpu_torch.train.pretext import PretextTrainer


def _rank(config, device):
    trainer = PretextTrainer(config, device=device)
    trainer.run()
    return trainer


def main(argv=None):
    args = parse_args(argv, description=__doc__)
    config = build_config(args, role="pretext")
    if (config.meshShape and config.pretextTrain
            and not (config.pretextManualControl
                     or config.pretextManualCollect)):
        return sharded_main(config, args.device, _rank)
    trainer = PretextTrainer(config, device=args.device)
    trainer.run()
    return trainer


if __name__ == "__main__":
    main()
