"""Host-side I/O of the port, a copy of ``parasitoids_tpu/io``: wind loading
and packing, emergence data, field/location data (``LocInfo``), site specs,
the xlsx reader, and the reference-format npz/json of a run."""

from .wind import read_wind_file, get_wind_data, pack_wind  # noqa: F401
from .emergence import emergence_data  # noqa: F401
from .save import load_run, save_run  # noqa: F401
