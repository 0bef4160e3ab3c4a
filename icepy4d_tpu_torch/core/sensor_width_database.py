"""Sensor-width lookup for EXIF-based intrinsics (counterpart of
`icepy4d_tpu/core/sensor_width_database.py`).

Backed by the port's own copy of the openMVG CameraSensorSizeDatabase
(BSD-licensed, `core/data/sensor_database.csv`, see
`core/data/SENSOR_DATABASE_LICENSE`), a small table of newer bodies the
CSV predates, and an optional user CSV ("make;model;width_mm" or
"make,model,width_mm" rows) layered on top.
"""

from __future__ import annotations

import csv
from pathlib import Path

BUNDLED_CSV = Path(__file__).parent / "data" / "sensor_database.csv"

_BUILTIN = {
    ("canon", "canon eos 2000d"): 22.3,
    ("canon", "canon eos 1200d"): 22.3,
    ("canon", "canon eos 6d"): 35.8,
    ("canon", "canon eos 5d mark iii"): 36.0,
    ("nikon", "nikon d850"): 35.9,
    ("nikon", "nikon d750"): 35.9,
    ("sony", "ilce-7m3"): 35.6,
    ("dji", "fc330"): 6.17,
    ("dji", "fc6310"): 13.2,
    ("gopro", "hero8 black"): 6.17,
}


class SensorWidthDatabase:
    """(make, model) -> sensor width in mm."""

    def __init__(self, csv_path: str | Path | None = None):
        self.table: dict[tuple[str, str], float] = {}
        if BUNDLED_CSV.exists():
            self._load_csv(BUNDLED_CSV)
        self.table.update(_BUILTIN)
        if csv_path is not None:
            self._load_csv(csv_path)

    def _load_csv(self, csv_path: str | Path) -> None:
        with open(csv_path, newline="") as f:
            sniff = f.read(2048)
            f.seek(0)
            delim = ";" if sniff.count(";") > sniff.count(",") else ","
            for row in csv.reader(f, delimiter=delim):
                if len(row) < 2:
                    continue
                try:
                    width = float(row[-1])
                except ValueError:
                    continue
                if len(row) >= 3:
                    key = (row[0].strip().lower(), row[1].strip().lower())
                else:
                    key = ("", row[0].strip().lower())
                self.table[key] = width

    def lookup(self, make: str, model: str) -> float:
        """Width of (make, model), else of the model alone, else of the
        first model that contains it or that it contains; LookupError
        when none is found."""
        make_l, model_l = make.strip().lower(), model.strip().lower()
        for key in ((make_l, model_l), ("", model_l)):
            if key in self.table:
                return self.table[key]
        for (_, md), w in self.table.items():
            if model_l and (model_l in md or md in model_l):
                return w
        raise LookupError(f"Sensor width unknown for {make} {model}")
