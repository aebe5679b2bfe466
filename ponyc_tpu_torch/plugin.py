"""Program-build plugins — ≙ the reference's compiler plugin system
(src/libponyc/plugin/plugin.c: dlopen'd shared objects exposing init/
final/help/parse_options/visit hooks that run inside the pass
pipeline).

Here the "compiler" is the Program build, so plugins are Python objects
(or modules) with the same hook shape, loaded by import path:

    class MyPlugin:
        name = "my-plugin"
        def init(self, program): ...                 # ≙ plugin init
        def visit_cohort(self, program, cohort): ... # ≙ AST visit hook
        def finalize(self, program): ...             # ≙ pre-codegen
        def help(self) -> str: ...
        def parse_options(self, argv) -> list: ...   # consume own flags

    plugins.load("mypkg.myplugin")       # import path (≙ dlopen path)
    plugins.register(MyPlugin())         # or an instance directly

Program.finalize() runs the hooks for every registered plugin: init
once, visit_cohort per cohort, finalize last — the same three-phase
shape as plugin.c:27-40.

The PyTorch port keeps its own registry (a copy of
``ponyc_tpu/plugin.py``): a plugin registered with the JAX package
never runs in a port build, nor the reverse.
"""

from __future__ import annotations

import importlib
from typing import Any, List


class PluginError(RuntimeError):
    pass


_registry: List[Any] = []


def register(plugin: Any) -> Any:
    """Register a plugin instance for subsequent Program builds."""
    for hook in ("init", "visit_cohort", "finalize"):
        fn = getattr(plugin, hook, None)
        if fn is not None and not callable(fn):
            raise PluginError(f"plugin hook {hook} is not callable")
    _registry.append(plugin)
    return plugin


def load(import_path: str) -> Any:
    """Load a plugin by module path (≙ --plugin=path dlopen). The module
    must expose PLUGIN (instance) or Plugin (class)."""
    mod = importlib.import_module(import_path)
    plug = getattr(mod, "PLUGIN", None)
    if plug is None:
        cls = getattr(mod, "Plugin", None)
        if cls is None:
            raise PluginError(
                f"{import_path} exposes neither PLUGIN nor Plugin")
        plug = cls()
    return register(plug)


def unregister_all() -> None:
    _registry.clear()


def active() -> List[Any]:
    return list(_registry)


def parse_options(argv: List[str]) -> List[str]:
    """Let every plugin strip its own flags (≙ plugin parse_options)."""
    for p in _registry:
        fn = getattr(p, "parse_options", None)
        if fn is not None:
            argv = list(fn(argv))
    return argv


def help_text() -> str:
    out = []
    for p in _registry:
        fn = getattr(p, "help", None)
        if fn is not None:
            out.append(f"{getattr(p, 'name', type(p).__name__)}: {fn()}")
    return "\n".join(out)


def run_build_hooks(program) -> None:
    """Called by Program.finalize() after layout is frozen."""
    for p in _registry:
        fn = getattr(p, "init", None)
        if fn is not None:
            fn(program)
    for p in _registry:
        fn = getattr(p, "visit_cohort", None)
        if fn is not None:
            for cohort in program.cohorts:
                fn(program, cohort)
    for p in _registry:
        fn = getattr(p, "finalize", None)
        if fn is not None:
            fn(program)
