"""Synthesized-program serialization and export (a port of
``microrts_tpu.synth.export``; ai/synthesis/grammar/model/
ProgramScript.java's chromosome files).

* ``dumps`` / ``loads`` — a stable text form (the dataclass reprs,
  parsed back in a namespace holding only the AST constructors); the
  text equals the JAX package's for the same program, so ``.dslprog``
  files move between the packages;
* ``to_module`` — a standalone importable Python module embedding the
  program plus a ``make(env)`` factory that compiles it with this
  package;
* ``save_program`` / ``load_program`` — file helpers.
"""

from __future__ import annotations

from . import dsl as _dsl
from .dsl import Program

# every frozen-dataclass AST node + the container types, nothing else
_AST_NAMES = [n for n in dir(_dsl)
              if isinstance(getattr(_dsl, n), type)
              and getattr(getattr(_dsl, n), "__dataclass_fields__", None)
              is not None]
_NAMESPACE = {n: getattr(_dsl, n) for n in _AST_NAMES}


def dumps(prog: Program) -> str:
    """Stable one-expression text form of a program (a tuple of
    dataclass reprs)."""
    inner = ",\n ".join(repr(c) for c in prog)
    return f"(\n {inner},\n)"


def loads(text: str) -> Program:
    """Parse ``dumps`` output.  Evaluated with NO builtins and only the
    AST constructors in scope, so the format cannot smuggle code."""
    prog = eval(text, {"__builtins__": {}}, dict(_NAMESPACE))
    if not isinstance(prog, tuple):
        raise ValueError("program text must be a tuple of commands")
    for c in prog:
        if type(c).__name__ not in _NAMESPACE:
            raise ValueError(f"unknown command node: {type(c).__name__}")
    return prog


def to_module(prog: Program, name: str = "synthesized") -> str:
    """Standalone module source: import + PROGRAM + make(env) factory."""
    names = sorted({type(c).__name__ for c in _walk(prog)})
    return (
        f'"""Auto-exported synthesized strategy: {name}.\n\n'
        f'Round-trips through microrts_tpu_torch.synth.export; build the\n'
        f'bot with ``make(env)`` (a (state, player, noise) ->\n'
        f'[B, H, W, 7] policy like every registry bot).\n"""\n\n'
        f"from microrts_tpu_torch.synth.dsl import ({', '.join(names)},\n"
        f"                                          compile_program)\n\n"
        f"PROGRAM = {dumps(prog)}\n\n\n"
        f"def make(env):\n"
        f"    return compile_program(env, PROGRAM)\n")


def _walk(prog):
    for c in prog:
        yield c
        body = getattr(c, "then", None) or getattr(c, "body", None)
        if body:
            yield from _walk(body)
        cond = getattr(c, "cond", None)
        if cond is not None:
            yield cond


def save_program(prog: Program, path: str) -> None:
    with open(path, "w") as f:
        f.write(dumps(prog) + "\n")


def load_program(path: str) -> Program:
    with open(path) as f:
        return loads(f.read())
