"""Property-testing front end: real hypothesis when installed, otherwise a
seeded random-sampling fallback with the same decorator surface.

The port's copy of the JAX package's ``repro/testing/hypo.py`` (it imports
neither): tests of the port draw through ``given``/``settings``/``st`` from
this module. When hypothesis is available the tests get real shrinking; in a
minimal environment the fallback draws a fixed number of deterministic
pseudo-random examples per test, so the properties are still exercised (no
silent skips). Only the strategy combinators the suites use are implemented.
"""
from __future__ import annotations

try:
    from hypothesis import given, settings, strategies as st  # noqa: F401

    HAVE_HYPOTHESIS = True
except ImportError:  # pragma: no cover - exercised only without hypothesis
    HAVE_HYPOTHESIS = False

    import functools
    import inspect
    import random

    _DEFAULT_EXAMPLES = 25

    class _Strategy:
        def __init__(self, draw):
            self._draw = draw

        def draw(self, rng: random.Random):
            return self._draw(rng)

        def map(self, fn):
            return _Strategy(lambda rng: fn(self._draw(rng)))

        def filter(self, pred):
            def draw(rng):
                for _ in range(10_000):
                    v = self._draw(rng)
                    if pred(v):
                        return v
                raise ValueError("filter predicate too strict for fallback")

            return _Strategy(draw)

    class _Strategies:
        @staticmethod
        def integers(min_value=0, max_value=None):
            hi = (min_value + 2**63) if max_value is None else max_value
            return _Strategy(lambda rng: rng.randint(min_value, hi))

        @staticmethod
        def floats(min_value=0.0, max_value=1.0, **_kw):
            return _Strategy(lambda rng: rng.uniform(min_value, max_value))

        @staticmethod
        def booleans():
            return _Strategy(lambda rng: rng.random() < 0.5)

        @staticmethod
        def sampled_from(seq):
            seq = list(seq)
            return _Strategy(lambda rng: seq[rng.randrange(len(seq))])

        @staticmethod
        def lists(elements, min_size=0, max_size=None):
            hi = min_size + 10 if max_size is None else max_size

            def draw(rng):
                return [elements.draw(rng) for _ in range(rng.randint(min_size, hi))]

            return _Strategy(draw)

        @staticmethod
        def tuples(*elements):
            return _Strategy(lambda rng: tuple(e.draw(rng) for e in elements))

    st = _Strategies()

    def given(*garg_strategies, **gkw_strategies):
        def deco(fn):
            sig = inspect.signature(fn)
            names = list(sig.parameters)
            # hypothesis semantics: positional strategies bind the rightmost
            # parameters; keyword strategies bind by name.
            free = [p for p in names if p not in gkw_strategies]
            pos_targets = free[len(free) - len(garg_strategies):] if garg_strategies else []
            bound = set(gkw_strategies) | set(pos_targets)

            @functools.wraps(fn)
            def wrapper(*args, **kwargs):
                # Read at call time so @settings works above OR below @given
                # (above: set on this wrapper; below: copied from fn by wraps).
                n = getattr(wrapper, "_fallback_max_examples", _DEFAULT_EXAMPLES)
                for i in range(n):
                    rng = random.Random(0xE1FA7 * 2654435761 + i)
                    kw = dict(kwargs)
                    for name, s in zip(pos_targets, garg_strategies):
                        kw[name] = s.draw(rng)
                    for name, s in gkw_strategies.items():
                        kw[name] = s.draw(rng)
                    fn(*args, **kw)

            # Hide strategy-bound parameters so pytest doesn't see fixtures.
            wrapper.__signature__ = sig.replace(
                parameters=[sig.parameters[p] for p in names if p not in bound]
            )
            return wrapper

        return deco

    def settings(max_examples: int = _DEFAULT_EXAMPLES, **_kw):
        """Decorator form only; global profiles are a no-op in the fallback."""

        def deco(fn):
            fn._fallback_max_examples = max_examples
            return fn

        return deco
