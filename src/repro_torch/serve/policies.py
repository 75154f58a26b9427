"""Admission policies for the serve engine's continuous-batching scheduler.

A policy is a pure function ``queue -> ordered queue`` deciding which
waiting :class:`~repro_torch.data.pipeline.Request`\\ s claim free KV-cache
slots first.  Policies never mutate the queue; the engine admits from the
front of the returned ordering.  Select one by name via
``ServeConfig(admission=...)`` or pass any callable with this signature.

Built-ins:

* ``fifo``                   — arrival order (the pre-batching behavior)
* ``shortest-prompt-first``  — fewest prompt tokens first (``sjf``): short
  prompts reach decode sooner, raising average slot utilization under
  mixed lengths
* ``priority``               — highest ``Request.priority`` first, FIFO
  within a priority class
"""
from __future__ import annotations

from typing import Callable, List, Union

from ..data.pipeline import Request

__all__ = ["AdmissionPolicy", "ADMISSION_POLICIES", "get_admission_policy",
           "fifo", "shortest_prompt_first", "priority_first"]

AdmissionPolicy = Callable[[List[Request]], List[Request]]


def fifo(queue: List[Request]) -> List[Request]:
    return list(queue)


def shortest_prompt_first(queue: List[Request]) -> List[Request]:
    return sorted(queue, key=lambda r: (len(r.tokens), r.rid))


def priority_first(queue: List[Request]) -> List[Request]:
    return sorted(queue, key=lambda r: (-r.priority, r.rid))


ADMISSION_POLICIES = {
    "fifo": fifo,
    "shortest-prompt-first": shortest_prompt_first,
    "sjf": shortest_prompt_first,
    "priority": priority_first,
}


def get_admission_policy(p: Union[str, AdmissionPolicy]) -> AdmissionPolicy:
    if callable(p):
        return p
    try:
        return ADMISSION_POLICIES[p]
    except KeyError:
        raise ValueError(
            f"unknown admission policy {p!r}; known: "
            f"{sorted(ADMISSION_POLICIES)} (or pass a callable "
            f"queue -> ordered queue)") from None
