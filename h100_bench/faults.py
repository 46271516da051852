"""Faults planted under the timed path, each of which the check has to
catch (``run.py --fault``; the benchmark's own runs plant none):

  answer  one probability of each answer altered where it is produced
  half    a train step over the first half of its batch, its loss the mean
          over that half
  state   a train step that computes its loss and returns the state as it
          found it
"""

from __future__ import annotations

import torch

FAULTS = ("answer", "half", "state")


def plant(fault: str | None, where: str, fn, system=None):
    if fault is None:
        return fn
    if fault == "answer" and where == "predict":
        def altered(b):
            out = fn(b)
            out[0] += 0.01
            return out
        return altered
    if fault == "half" and where == "train_step":
        def half(b):
            h = b["dense"].shape[0] // 2
            out = {"dense": b["dense"][:h], "labels": b["labels"][:h]}
            if "offsets" in b:  # the CSR wire: the first h bags of each table
                off = b["offsets"][:, :h + 1].contiguous()
                c = int(off[:, -1].max())
                out.update(ids=b["ids"][:, :c].contiguous(), offsets=off)
            else:
                c = b["ids"].shape[1] // b["dense"].shape[0] * h
                out.update(ids=b["ids"][:, :c].contiguous(),
                           mask=b["mask"][:, :c].contiguous())
            return fn(out)
        return half
    if fault == "state" and where == "train_step":
        def unchanged(b):
            state = system.state_tensors()
            saved = [t.clone() for t in state]
            loss = fn(b)
            with torch.no_grad():
                for t, s in zip(state, saved):
                    t.copy_(s)
            return loss
        return unchanged
    raise ValueError(f"fault {fault!r} has no place in {where}")
