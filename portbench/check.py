"""What every entry's check shares: freeing the program's state before the
reference runs, the matrix as float64 column panels for the reference, and
the verdict. The comparisons themselves are each entry's ``numbers``
(``entries/<entry>.py``), run after the window, once peak memory has been
read."""

from __future__ import annotations

import gc

import torch

from portbench import inputs


def release(*devices) -> None:
    gc.collect()
    if any(torch.device(d).type == "cuda" for d in devices):
        torch.cuda.empty_cache()


def panels(a: torch.Tensor, nb: int) -> list:
    """``a``'s tile columns in float64, each from its diagonal tile down."""
    return [inputs.column(a, nb, j, torch.float64) for j in range(a.shape[0] // nb)]


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, the checks {name: {value, limit}}); NaN passes no limit."""
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    return all(v <= limits[k] for k, v in numbers.items()), checks
