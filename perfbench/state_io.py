"""Copies of a simulation's state between the program and the reference.

``to_host`` copies a state (dataclasses, tuples, lists, dicts, tensors,
numpy scalars) into host memory as ``Record``s, which name their class
by its module path inside its package and hold plain values.
``rebuild`` makes the same state out of another package's classes of
those names (the frozen plain reference mirrors the program's module
tree), its tensors moved to a device."""
import dataclasses
import importlib

import torch


@dataclasses.dataclass
class Record:
    """A dataclass instance in host memory: its class's module path
    below its package, its class name and its fields' values."""
    module: str
    cls: str
    values: dict

    def __getitem__(self, name):
        return self.values[name]


def to_host(obj):
    """``obj`` with every tensor copied to host memory and every
    dataclass instance turned into a Record."""
    if torch.is_tensor(obj):
        return obj.detach().to("cpu", copy=True)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        mod = type(obj).__module__
        return Record(mod.split(".", 1)[1] if "." in mod else "",
                      type(obj).__qualname__,
                      {f.name: to_host(getattr(obj, f.name))
                       for f in dataclasses.fields(obj)})
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_host(v) for v in obj)
    if isinstance(obj, dict):
        return {k: to_host(v) for k, v in obj.items()}
    return obj


def rebuild(rec, package, device):
    """``rec`` (from ``to_host``) as instances of ``package``'s classes of
    the same module paths and names, its tensors on ``device``."""
    if torch.is_tensor(rec):
        return rec.to(device)
    if isinstance(rec, Record):
        mod = importlib.import_module(f"{package}.{rec.module}")
        cls = getattr(mod, rec.cls)
        return cls(**{k: rebuild(v, package, device)
                      for k, v in rec.values.items()})
    if isinstance(rec, (list, tuple)):
        return type(rec)(rebuild(v, package, device) for v in rec)
    if isinstance(rec, dict):
        return {k: rebuild(v, package, device) for k, v in rec.items()}
    return rec
