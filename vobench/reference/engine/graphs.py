"""Eager ``cond`` and ``while_loop``: the reference reads each predicate on
the host, as the port does off the card."""

from __future__ import annotations

from typing import Callable

import torch


def cond(pred: torch.Tensor, true_fn: Callable, false_fn: Callable, operands=()):
    """``true_fn(*operands)`` if ``pred`` else ``false_fn(*operands)``."""
    return true_fn(*operands) if bool(pred) else false_fn(*operands)


def while_loop(cond_fn: Callable, body_fn: Callable, carry):
    """``carry = body_fn(carry)`` while ``cond_fn(carry)`` holds."""
    while bool(cond_fn(carry)):
        carry = body_fn(carry)
    return carry
