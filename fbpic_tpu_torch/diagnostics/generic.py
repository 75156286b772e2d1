"""openPMD diagnostics: the common file / iteration layout.

Every diagnostic works in two steps:

- ``collect``: the device work and the copies to the host.  It returns
  the openPMD records of each file it writes, as numpy:
  ``{file name: Records}``, where ``Records`` maps each HDF5 path to its
  data (None for a group) and its attributes, in write order: exactly
  what the HDF5 write stores.
- ``write_records``: serialise those records with h5py, into
  ``<write_dir>/hdf5/<file name>``.

``write(sim)`` does both when the diagnostic's period says so.  Files are
openPMD-1.0.0 file-based series (``data%08d.h5``), as fbpic_tpu writes
them.  Without h5py, ``write_records`` raises ImportError: nothing is
written in another format, and no write is skipped.
"""
import datetime
import os

import numpy as np

from .data_dict import (unit_dimension_dict, macro_weighted_dict,
                        weighting_power_dict)
from .. import __version__


def _s(text):
    """Fixed-length bytes string for HDF5 attrs."""
    return np.bytes_(text)


class Records(dict):
    """HDF5 path -> (data or None for a group, attribute dict)."""

    def group(self, path):
        """The attribute dict of group ``path`` (created if absent)."""
        return self.setdefault(path.rstrip("/") or "/", (None, {}))[1]

    def dataset(self, path, data):
        """Store dataset ``path`` (replacing it); its attribute dict."""
        self[path] = (np.asarray(data), {})
        return self[path][1]


def _h5py():
    try:
        import h5py
    except ImportError as err:
        raise ImportError(
            "fbpic_tpu_torch writes openPMD files with h5py, which is not "
            "installed; collect() returns the same records as numpy "
            "without it") from err
    return h5py


def write_records_file(fullpath, records, mode="a"):
    """Write one file's Records with h5py (groups with require_group,
    datasets replaced), attributes after each object."""
    h5py = _h5py()
    with h5py.File(fullpath, mode=mode) as f:
        for path, (data, attrs) in records.items():
            if data is None:
                obj = f if path == "/" else f.require_group(path)
            else:
                if path in f:
                    del f[path]
                obj = f.create_dataset(path, data=data)
            for key, value in attrs.items():
                obj.attrs[key] = value


class OpenPMDDiagnostic(object):
    """Base class of the openPMD diagnostics."""

    #: h5py mode of the files (append: several diagnostics share a file)
    file_mode = "a"

    def __init__(self, period=None, comm=None, write_dir=None,
                 iteration_min=0, iteration_max=np.inf,
                 dt_period=None, dt_sim=None):
        self.rank = 0 if comm is None else getattr(comm, "rank", 0)
        if period is None and dt_period is None:
            raise ValueError(
                "You need to pass either `period` or `dt_period` "
                "to the diagnostics.")
        if period is not None and dt_period is not None:
            raise ValueError(
                "Pass either `period` or `dt_period`, not both.")
        if period is None:
            period = dt_period / dt_sim
        self.period = max(1, int(round(period)))
        self.iteration_min = iteration_min
        self.iteration_max = iteration_max
        self.comm = comm
        if write_dir is None:
            self.write_dir = os.path.join(os.getcwd(), "diags")
        else:
            self.write_dir = os.path.abspath(write_dir)
        if self.rank == 0:
            os.makedirs(os.path.join(self.write_dir, "hdf5"), exist_ok=True)

    # -----------------------------------------------------------------
    def write(self, sim):
        """Collect and write the records if the current iteration matches
        the period.  ``sim``: the Simulation, or an int iteration for
        reference-style calls."""
        iteration = sim if isinstance(sim, int) else sim.iteration
        if (iteration % self.period == 0
                and self.iteration_min <= iteration < self.iteration_max):
            self.write_records(self.collect(sim, iteration))

    def collect(self, sim, iteration=None):
        """{file name: Records} of this diagnostic at the current state
        (numpy, on the host)."""
        raise NotImplementedError

    def write_records(self, files):
        """Serialise collected records with h5py (rank 0 only)."""
        if self.rank != 0:
            return
        for name, records in files.items():
            write_records_file(os.path.join(self.write_dir, "hdf5", name),
                               records, self.file_mode)

    # -----------------------------------------------------------------
    def setup_openpmd_file(self, rec, iteration, time, dt):
        root = rec.group("/")
        root["openPMD"] = _s("1.0.0")
        root["openPMDextension"] = np.uint32(1)
        root["software"] = _s("fbpic_tpu_torch " + __version__)
        root["date"] = _s(
            datetime.datetime.now().strftime("%Y-%m-%d %H:%M:%S %z"))
        root["meshesPath"] = _s("fields/")
        root["particlesPath"] = _s("particles/")
        root["iterationEncoding"] = _s("fileBased")
        root["iterationFormat"] = _s("data%T.h5")
        root["basePath"] = _s("/data/%T/")
        base = rec.group("/data/%d" % iteration)
        base["time"] = time
        base["dt"] = dt
        base["timeUnitSI"] = 1.0

    def setup_openpmd_record(self, attrs, quantity):
        attrs["unitDimension"] = unit_dimension_dict[quantity]
        attrs["timeOffset"] = 0.0

    def setup_openpmd_component(self, attrs):
        attrs["unitSI"] = 1.0


def setup_particle_record(attrs, quantity):
    """unitDimension, timeOffset, macroWeighted, weightingPower."""
    attrs["unitDimension"] = unit_dimension_dict[quantity]
    attrs["timeOffset"] = 0.0
    attrs["macroWeighted"] = macro_weighted_dict[quantity]
    attrs["weightingPower"] = weighting_power_dict[quantity]


def records_difference(files_a, files_b, skip_attrs=("date", "software")):
    """Hold collected records ``files_b`` against ``files_a`` (the same
    diagnostic run on two devices, say): the same files, paths and
    attributes (exactly, except ``skip_attrs``), datasets of the same
    shape and dtype, integer data exactly; raises ValueError otherwise.
    Returns {file:path: largest |b - a| of a float dataset over the
    largest |a| of its record} (the record of a component dataset is its
    group, e.g. E/r, E/t and E/z; of any other dataset, itself)."""
    out = {}
    if sorted(files_a) != sorted(files_b):
        raise ValueError(f"files {sorted(files_a)} != {sorted(files_b)}")
    for name, rec_a in files_a.items():
        rec_b = files_b[name]
        if list(rec_a) != list(rec_b):
            raise ValueError(f"{name}: the paths differ")
        for path, (data_a, attrs_a) in rec_a.items():
            data_b, attrs_b = rec_b[path]
            keys = [k for k in attrs_a if k not in skip_attrs]
            if keys != [k for k in attrs_b if k not in skip_attrs]:
                raise ValueError(f"{name}:{path}: the attributes differ")
            for k in keys:
                a, b = np.asarray(attrs_a[k]), np.asarray(attrs_b[k])
                if a.dtype != b.dtype or not np.array_equal(a, b):
                    raise ValueError(f"{name}:{path}@{k}: {a} != {b}")
            if data_a is None or data_b is None:
                if (data_a is None) != (data_b is None):
                    raise ValueError(f"{name}:{path}: group vs dataset")
                continue
            if data_a.shape != data_b.shape or data_a.dtype != data_b.dtype:
                raise ValueError(f"{name}:{path}: {data_a.shape} "
                                 f"{data_a.dtype} != {data_b.shape} "
                                 f"{data_b.dtype}")
            if not np.issubdtype(data_a.dtype, np.floating):
                if not np.array_equal(data_a, data_b):
                    raise ValueError(f"{name}:{path}: the values differ")
                continue
            parent = path.rsplit("/", 1)[0]
            record = [data_a]
            if "unitDimension" not in attrs_a and "unitDimension" in \
                    rec_a.get(parent, (None, {}))[1]:
                record = [d for p, (d, _) in rec_a.items() if d is not None
                          and p.rsplit("/", 1)[0] == parent]
            scale = max(np.abs(d).max(initial=0.0) for d in record)
            err = np.abs(data_b - data_a).max(initial=0.0)
            out[f"{name}:{path}"] = float(err / scale) if scale else \
                float(err)
    return out
