"""RL: the PPO learner (ppo.py), the fused device rollout
(rollout_device.py), and the entry point (port of RL.py):

    python -m var_tpu_torch.rl --env arms [--device cpu] --set KNOB=VALUE ...

It loads the frozen VAR, then trains (RLTrain=True) or evaluates
(RLTrain=False) per the profile's knobs. The device defaults to CUDA; --device
cpu runs on the CPU. With meshShape set, training runs on its ranks
(cli.py::sharded_main); evaluation runs in one process, as in the JAX
package. The entry point lives in this package because the package takes
the name `var_tpu_torch.rl`.
"""


def _rank(config, env, device):
    from var_tpu_torch.train.rl import RLTrainer

    trainer = RLTrainer(config, env=env, device=device)
    trainer.run()
    return trainer


def main(argv=None):
    # imported here: train.rl imports this package's modules
    from var_tpu_torch.cli import build_config, parse_args, sharded_main
    from var_tpu_torch.train.rl import RLTrainer

    args = parse_args(argv, description=__doc__)
    config = build_config(args, role="RL")
    if config.meshShape and config.RLTrain and not config.RLManualControl:
        return sharded_main(config, args.device, _rank, (args.env,))
    trainer = RLTrainer(config, env=args.env, device=args.device)
    trainer.run()
    return trainer
