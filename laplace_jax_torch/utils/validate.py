"""The predictive over a validation loader (port of
`laplace_jax/utils/validate.py`): runs the Laplace predictive on every batch
and aggregates a running metric (or an offline callable)."""

from __future__ import annotations

import inspect

import torch

from laplace_jax_torch.enums import LinkApprox, PredType


def validate(laplace, val_loader, loss, pred_type: PredType | str = PredType.GLM,
             link_approx: LinkApprox | str = LinkApprox.PROBIT, n_samples: int = 100,
             dict_key_y: str = "labels") -> float:
    """The metric `loss` of `laplace`'s predictive (with `fitting=True`)
    over `val_loader`. An online metric (`reset`/`update`/`compute`) gets
    `update(mean, var, y)` on a (mean, var) predictive when its signature
    takes three arguments, else `update(mean, y)`; a metric with no
    inspectable signature is probed with three arguments once, then two on
    a TypeError. An offline callable gets the concatenated outputs."""
    is_online = hasattr(loss, "update") and hasattr(loss, "compute")
    if is_online:
        loss.reset()
        # the arity from the signature, not from a caught TypeError: a
        # TypeError raised inside a metric must surface
        try:
            update_takes_var = _accepts_n_positional(inspect.signature(loss.update), 3)
        except (TypeError, ValueError):
            update_takes_var = None
    # imported here: nnmodel imports models.resnet, which imports this package
    from laplace_jax_torch.nnmodel import unpack_batch

    output_means, output_vars, targets = [], [], []

    for data in val_loader:
        X, y = unpack_batch(data, dict_key_y)
        out = laplace(X, pred_type=pred_type, link_approx=link_approx,
                      n_samples=n_samples, fitting=True)
        mean = out[0] if isinstance(out, tuple) else out
        y = torch.as_tensor(y, device=mean.device)
        if isinstance(out, tuple):
            if is_online:
                if update_takes_var is None:  # uninspectable: probe once
                    try:
                        loss.update(out[0], out[1], y)
                        update_takes_var = True
                    except TypeError:
                        update_takes_var = False
                        loss.update(out[0], y)
                elif update_takes_var:
                    loss.update(out[0], out[1], y)
                else:
                    loss.update(out[0], y)
            else:
                output_means.append(out[0])
                output_vars.append(out[1])
                targets.append(y)
        elif is_online:
            loss.update(out, y)
        else:
            output_means.append(out)
            targets.append(y)

    if is_online:
        return float(loss.compute())
    means, tgts = torch.cat(output_means), torch.cat(targets)
    if output_vars:
        return float(loss(means, torch.cat(output_vars), tgts))
    return float(loss(means, tgts))


def _accepts_n_positional(sig: inspect.Signature, n: int) -> bool:
    """True if the signature can be called with `n` positional arguments."""
    count = 0
    for p in sig.parameters.values():
        if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD):
            count += 1
        elif p.kind is p.VAR_POSITIONAL:
            return True
    return count >= n
