"""Minimal stand-in for the ``hypothesis`` property-testing API.

The port's copy of the JAX package's ``utils/hypofallback.py`` (numpy
only), draw for draw: the same strategy under the same test name yields
the same examples in both packages.  The tier-1 suite uses a small slice
of hypothesis (``given`` / ``settings`` /
``strategies.integers|floats|lists|composite``).  On containers without the
real package, tests fall back to this module: each strategy draws
deterministic pseudo-random examples from a fixed-seed generator and
``given`` simply re-runs the test body ``max_examples`` times.  No shrinking,
no example database — just enough to keep the property tests exercising the
same input space on a clean machine.

Usage (in tests)::

    try:
        from hypothesis import given, settings, strategies as st
    except ImportError:                       # clean container
        from repro_torch.utils.hypofallback import (given, settings,
                                                    strategies as st)
"""
from __future__ import annotations

import zlib
from typing import Any, Callable, Sequence

import numpy as np

__all__ = ["given", "settings", "strategies", "HealthCheck"]

_DEFAULT_EXAMPLES = 10


class SearchStrategy:
    """A value generator: ``example(rng)`` draws one example."""

    def __init__(self, sample: Callable[[np.random.Generator], Any]):
        self._sample = sample

    def example(self, rng: np.random.Generator) -> Any:
        return self._sample(rng)

    def map(self, fn: Callable[[Any], Any]) -> "SearchStrategy":
        return SearchStrategy(lambda rng: fn(self._sample(rng)))

    def filter(self, pred: Callable[[Any], bool],
               max_tries: int = 100) -> "SearchStrategy":
        def sample(rng):
            for _ in range(max_tries):
                x = self._sample(rng)
                if pred(x):
                    return x
            raise ValueError("filter predicate never satisfied")
        return SearchStrategy(sample)


class strategies:
    """Namespace mimicking ``hypothesis.strategies``."""

    @staticmethod
    def integers(min_value: int, max_value: int) -> SearchStrategy:
        return SearchStrategy(
            lambda rng: int(rng.integers(min_value, max_value + 1)))

    @staticmethod
    def floats(min_value: float, max_value: float, **_: Any) -> SearchStrategy:
        lo, hi = float(min_value), float(max_value)

        def sample(rng):
            # hit the endpoints occasionally, like hypothesis does
            r = rng.random()
            if r < 0.05:
                return lo
            if r < 0.10:
                return hi
            return float(rng.uniform(lo, hi))
        return SearchStrategy(sample)

    @staticmethod
    def booleans() -> SearchStrategy:
        return SearchStrategy(lambda rng: bool(rng.integers(0, 2)))

    @staticmethod
    def sampled_from(seq: Sequence[Any]) -> SearchStrategy:
        items = list(seq)
        return SearchStrategy(lambda rng: items[int(rng.integers(len(items)))])

    @staticmethod
    def lists(elements: SearchStrategy, min_size: int = 0,
              max_size: int = 10, **_: Any) -> SearchStrategy:
        def sample(rng):
            n = int(rng.integers(min_size, max_size + 1))
            return [elements.example(rng) for _ in range(n)]
        return SearchStrategy(sample)

    @staticmethod
    def composite(fn: Callable[..., Any]) -> Callable[..., SearchStrategy]:
        def make(*args: Any, **kw: Any) -> SearchStrategy:
            def sample(rng):
                return fn(lambda strat: strat.example(rng), *args, **kw)
            return SearchStrategy(sample)
        return make


class _AttrSink:
    def __getattr__(self, name: str) -> str:  # pragma: no cover
        return name


# attribute sink so ``suppress_health_check=[HealthCheck.too_slow]`` parses
HealthCheck = _AttrSink()


def given(*strats: SearchStrategy, **kwstrats: SearchStrategy):
    """Re-run the test over ``max_examples`` deterministic draws.

    The returned wrapper takes NO parameters (all strategy-bound arguments
    are filled here) so pytest does not mistake them for fixtures — matching
    how real hypothesis rewrites the signature.
    """
    def deco(fn: Callable) -> Callable:
        def wrapper():
            n = getattr(wrapper, "_hypofallback_max_examples",
                        _DEFAULT_EXAMPLES)
            # crc32, not hash(): str hashing is salted per process and would
            # break the docstring's cross-run determinism promise
            rng = np.random.default_rng(
                zlib.crc32(fn.__qualname__.encode()))
            for _ in range(n):
                args = [s.example(rng) for s in strats]
                kwargs = {k: s.example(rng) for k, s in kwstrats.items()}
                fn(*args, **kwargs)
        wrapper.__name__ = fn.__name__
        wrapper.__qualname__ = fn.__qualname__
        wrapper.__module__ = fn.__module__
        wrapper.__doc__ = fn.__doc__
        # settings() applied *inside* given: carry the attribute over
        wrapper.__dict__.update(getattr(fn, "__dict__", {}))
        return wrapper
    return deco


def settings(max_examples: int = _DEFAULT_EXAMPLES, deadline: Any = None,
             **_: Any):
    """Record ``max_examples``; ``deadline`` and the rest are ignored."""
    def deco(fn: Callable) -> Callable:
        fn._hypofallback_max_examples = max_examples
        return fn
    return deco
