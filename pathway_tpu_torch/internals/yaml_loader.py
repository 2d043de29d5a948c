"""``pw.load_yaml`` — deployable app templates (reference
``internals/yaml_loader.py:74-218``): ``$var`` references and
``!pw.some.Class`` instantiation tags.

Tags ``!pw.``, ``!pathway.`` and ``!pathway_tpu_torch.`` resolve in this
package.  A ``!pathway_tpu.`` tag (the JAX package's prefix) is refused
with an error that names this package's, and never imported.  PyYAML is
imported when :func:`load_yaml` runs, not with the package."""

from __future__ import annotations

import functools
import importlib
from typing import Any, IO

__all__ = ["load_yaml"]

#: tag prefixes that name this package
_PREFIXES = ("pw", "pathway", "pathway_tpu_torch")


class _Tagged:
    def __init__(self, path: str, value: Any):
        self.path = path
        self.value = value


def _construct_tagged(loader, tag_suffix: str, node) -> Any:
    import yaml

    if isinstance(node, yaml.MappingNode):
        value = loader.construct_mapping(node, deep=True)
    elif isinstance(node, yaml.SequenceNode):
        value = loader.construct_sequence(node, deep=True)
    else:
        value = loader.construct_scalar(node)
    return _Tagged(tag_suffix, value)


@functools.cache
def _loader():
    """A SafeLoader subclass that turns every ``!tag`` into ``_Tagged``
    (made at the first load, when PyYAML is imported)."""
    import yaml

    class _Loader(yaml.SafeLoader):
        pass

    _Loader.add_multi_constructor("!", _construct_tagged)
    return _Loader


def _resolve_path(path: str) -> Any:
    """'pw.xpacks.llm.embedders.TorchEncoderEmbedder' -> the object."""
    parts = path.split(".")
    if parts[0] == "pathway_tpu":
        raise ValueError(
            f"yaml tag !{path} names the JAX package (pathway_tpu), which this package does not "
            f"import: write !pathway_tpu_torch.{'.'.join(parts[1:])} (or !pw.{'.'.join(parts[1:])})"
        )
    if parts[0] in _PREFIXES:
        module: Any = importlib.import_module("pathway_tpu_torch")
        parts = parts[1:]
    else:
        module = importlib.import_module(parts[0])
        parts = parts[1:]
    obj = module
    for i, p in enumerate(parts):
        try:
            obj = getattr(obj, p)
        except AttributeError:
            # maybe a submodule not yet imported
            obj = importlib.import_module(
                obj.__name__ + "." + p if hasattr(obj, "__name__") else p
            )
    return obj


def _instantiate(node: Any, variables: dict[str, Any]) -> Any:
    if isinstance(node, _Tagged):
        target = _resolve_path(node.path)
        value = _instantiate(node.value, variables)
        if isinstance(value, dict):
            return target(**value) if callable(target) else target
        if value in (None, ""):
            return target() if callable(target) else target
        if isinstance(value, list):
            return target(*value)
        return target(value)
    if isinstance(node, dict):
        return {k: _instantiate(v, variables) for k, v in node.items()}
    if isinstance(node, list):
        return [_instantiate(v, variables) for v in node]
    if isinstance(node, str) and node.startswith("$"):
        name = node[1:]
        if name in variables:
            return variables[name]
        raise KeyError(f"undefined yaml variable ${name}")
    return node


def load_yaml(stream: str | bytes | IO) -> Any:
    """Parse a config with ``$var`` references and ``!pw.x.y.Class`` object
    tags (reference ``pw.load_yaml``)."""
    import yaml

    raw = yaml.load(stream, Loader=_loader())  # noqa: S506 — custom safe loader
    if not isinstance(raw, dict):
        return _instantiate(raw, {})
    # top-level keys are $variables for each other, regardless of document
    # order: resolve iteratively, deferring keys whose $refs aren't ready
    # yet.  A leading $ on a KEY marks a private variable (reference app
    # templates: "$llm:", "$sources:", ... referenced as $llm) — the $ is
    # not part of the variable name, and $-keys are dropped from the
    # returned config.
    variables: dict[str, Any] = {}
    todo: dict[Any, Any] = {}
    private: set = set()
    for k, v in raw.items():
        if isinstance(k, str) and k.startswith("$$"):
            name = k[1:]  # escaped: "$$x" is the literal key "$x"
        elif isinstance(k, str) and k.startswith("$"):
            name = k[1:]
            private.add(name)
        else:
            name = k
        if name in todo:
            raise KeyError(
                f"yaml config defines both {k!r} and a key that resolves "
                f"to the same variable name {name!r}"
            )
        todo[name] = v
    while todo:
        progressed = False
        deferred: dict[str, Any] = {}
        last_error: Exception | None = None
        for key, value in todo.items():
            try:
                variables[key] = _instantiate(value, variables)
                progressed = True
            except KeyError as e:
                deferred[key] = value
                last_error = e
        if not progressed:
            raise KeyError(
                f"unresolvable yaml variable reference(s): {last_error}"
            )
        todo = deferred
    return {k: v for k, v in variables.items() if k not in private}
