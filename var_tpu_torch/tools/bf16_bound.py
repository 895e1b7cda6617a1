"""What float32 accumulation guarantees for a bf16 product at
computeDtype='bfloat16'.

A bf16 convolution or dense layer (flax's Conv or Dense at bf16, XLA's
contract, and the port's models/encoders.py::conv and dense) takes bf16
operands, sums their products in float32 in some order, and rounds the sum
to bf16 once. With K products per output, a float32 sum in any order lies
within gamma_K * A of the exact product, where A is the product of the
absolute values (|W| * |x|) and gamma_K = K u / (1 - K u), u = 2^-24
(Higham, Accuracy and Stability of Numerical Algorithms, 2nd ed., 3.1);
rounding that sum to bf16 adds at most half a bf16 spacing. So for every
output element

    |got - exact| <= ulp(|exact| + gamma_K A) / 2 + gamma_K A     (1)

where ulp(v) is the bf16 spacing at v. An output whose exact value is near
zero while A is not (a sum that cancels) may land many bf16 steps from the
exactly rounded value, since its steps are finer than gamma_K A: no
implementation that sums in float32 can promise one step there, the CPU's
included. `product_bound` is (1).

The per-layer tests (tests/test_torch_kernels.py) hold every conv of the
four image stacks and every VAR head layer to (1), on the CPU and on the
card. (1) says nothing useful end to end: pushed through a stack, worst
case or to first order, it comes to 40-2,000 EPS (2^-8) of a unit
embedding on seeded draws, while two sides lie within a few EPS of each
other. The end-to-end bf16 checks (tools/rl_check.py,
tests/test_torch_bf16.py) hold measured constants instead, and a control
route that reduces partial sums in bf16 must fail them.
"""
from __future__ import annotations

import torch

U32 = 2.0 ** -24  # float32 unit roundoff
BF16_MANTISSA = 7  # stored bits of a bf16 significand


def ulp(v: torch.Tensor) -> torch.Tensor:
    """The bf16 spacing at |v| (float64): 2^(e - 7) for 2^e <= |v| <
    2^(e+1), 2^-133 among the subnormals."""
    v = v.double().abs().clamp(min=2.0 ** -133)
    e = torch.floor(torch.log2(v)).clamp(min=-126)
    return torch.exp2(e - BF16_MANTISSA)


def gamma(k: int, u: float = U32) -> float:
    """gamma_k = k u / (1 - k u): the relative error bound of a float32 sum
    of k products, in any order."""
    return k * u / (1 - k * u)


def product_bound(exact: torch.Tensor, magnitude: torch.Tensor,
                  k: int) -> torch.Tensor:
    """(1): how far a bf16 product summed in float32 and rounded once may
    lie from `exact`, given the product of absolute values `magnitude` and
    `k` products per output."""
    g = gamma(k)
    return 0.5 * ulp(exact.abs() + g * magnitude) + g * magnitude
