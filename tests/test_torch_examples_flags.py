"""The port's example scripts (``tianshou_tpu_torch/examples/``) against the
JAX package's (``examples/``), part (a): flags.

Each JAX script's parser is captured where its ``main`` parses: the script
is loaded with ``runpy.run_path`` (so its ``__main__`` block does not run),
``argparse.ArgumentParser.parse_args`` is patched to record the parser and
raise, and ``main`` is called.  The port module's ``parser()`` must have the
same arguments in the same order, each with the same option strings,
destination, default, type, choices, ``nargs`` and action, except that the
JAX ``--platform`` (default ``None``) is the port's ``--device`` (default
``"cuda"``).  ``highlevel_dqn`` has no JAX flags, and the port's has only
``--device``.  ``make_d4rl_demo`` is held against ``tests/make_d4rl_demo.py``.

This file also holds what the other two files of the examples import: the
scripts' list, the loader of a JAX script and the one-thread fixture.
(b) is ``test_torch_examples_wiring.py``, (c) ``test_torch_examples_e2e.py``.
"""

import argparse
import importlib
import pathlib
import runpy

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
SCRIPTS = sorted(p.stem for p in (REPO / "examples").glob("*.py"))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread a test: the suite runs in several worker processes,
    and their threads would share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class Parsed(Exception):
    """Raised in place of a JAX script's ``parse_args``."""


def jax_main(name: str):
    """The ``main`` of the JAX script ``examples/<name>.py`` (of
    ``tests/make_d4rl_demo.py`` for ``make_d4rl_demo``), loaded without
    running its ``__main__`` block."""
    path = REPO / ("tests" if name == "make_d4rl_demo" else "examples") / f"{name}.py"
    return runpy.run_path(str(path))["main"]


def port_module(name: str):
    return importlib.import_module(f"tianshou_tpu_torch.examples.{name}")


def jax_parser(name: str, monkeypatch) -> argparse.ArgumentParser:
    captured = {}

    def parse_args(self, *args, **kwargs):
        captured["parser"] = self
        raise Parsed

    main = jax_main(name)
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", parse_args)
    with pytest.raises(Parsed):
        main()
    monkeypatch.undo()
    return captured["parser"]


def _arguments(parser: argparse.ArgumentParser) -> list[tuple]:
    return [(tuple(a.option_strings), a.dest, a.default, a.type, a.choices, a.nargs, type(a).__name__)
            for a in parser._actions if not isinstance(a, argparse._HelpAction)]


def test_every_script_has_a_port_module():
    assert len(SCRIPTS) == 16, SCRIPTS
    ported = {p.stem for p in (REPO / "tianshou_tpu_torch" / "examples").glob("*.py")}
    assert ported == set(SCRIPTS) | {"__init__", "make_d4rl_demo"}


@pytest.mark.parametrize("name", SCRIPTS + ["make_d4rl_demo"])
def test_flags_match_the_jax_script(name, monkeypatch):
    port = _arguments(port_module(name).parser())
    if name == "highlevel_dqn":
        assert "argparse" not in (REPO / "examples" / f"{name}.py").read_text()
        assert port == [(("--device",), "device", "cuda", None, None, None, "_StoreAction")]
        return
    expected = [(("--device",), "device", "cuda", *rest[2:]) if opts == ("--platform",) else (opts, *rest)
                for opts, *rest in _arguments(jax_parser(name, monkeypatch))]
    assert (("--platform",), "platform", None) not in [a[:3] for a in port]
    assert port == expected
