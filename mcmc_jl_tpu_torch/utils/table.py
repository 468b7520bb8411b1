"""A minimal column table for chain output (port of
``mcmc_jl_tpu/utils/table.py``: host-side numpy, its column index built on
the first lookup by name).

The reference stores samples/gradients in ``DataFrames.DataFrame`` objects
(reference: src/MCMC.jl:58-80, src/runners/SerialMC.jl:70-84).  We keep the
heavy maths on-device as plain arrays; :class:`Table` is a thin host-side view
that provides the DataFrame-ish ergonomics the reference API exposes (column
names from the parameter map, ``head``, ``chain.samples["x"]`` indexing) and a
``to_pandas()`` escape hatch.
"""
from __future__ import annotations

import numpy as np


class Table:
    """Column-named view over a 2-D (rows, cols) array."""

    def __init__(self, data, columns):
        data = np.asarray(data)
        if data.ndim == 1:
            data = data[:, None]
        assert data.ndim == 2, f"Table expects 2-D data, got {data.shape}"
        assert data.shape[1] == len(columns), (
            f"{data.shape[1]} columns of data but {len(columns)} names"
        )
        self.values = data
        self.columns = list(columns)
        # name -> column, built on the first lookup by name: a run packages
        # two tables a chain, and at 4096 chains of 4096 coordinates
        # building it up front took most of the packaging's seconds
        self._index = None

    # -- basic protocol ----------------------------------------------------
    def __len__(self):
        return self.values.shape[0]

    @property
    def shape(self):
        return self.values.shape

    @property
    def nrow(self):
        return self.values.shape[0]

    @property
    def ncol(self):
        return self.values.shape[1]

    @property
    def empty(self):
        return self.values.size == 0

    def __getitem__(self, key):
        """``t["name"]`` -> column vector; ``t[i]`` -> i-th column (0-based);
        ``t[rows, col]`` -> sliced column."""
        if isinstance(key, tuple):
            rows, col = key
            return self._col(col)[rows]
        return self._col(key)

    def _col(self, key):
        if isinstance(key, str):
            if self._index is None:
                self._index = {c: i for i, c in enumerate(self.columns)}
            return self.values[:, self._index[key]]
        return self.values[:, key]

    def head(self, n=6):
        return Table(self.values[:n], self.columns)

    def to_pandas(self):
        import pandas as pd

        return pd.DataFrame(self.values, columns=self.columns)

    def __repr__(self):
        with np.printoptions(precision=5, threshold=12, edgeitems=3):
            body = str(self.values)
        return f"Table({self.nrow}x{self.ncol}; columns={self.columns})\n{body}"
