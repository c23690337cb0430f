"""Dict-of-arrays wrapper supporting uniform slicing/append/map (copy of
``multimodalfilter_tpu/utils/slice_wrapper.py``, which imports no JAX).

Capability parity with ``fannypack.utils.SliceWrapper`` as used by the
reference (crossmodal/tasks/_door.py:301, crossmodal/eval_helpers.py:88-121):
wraps either a dict of sequences or a single sequence and broadcasts
__getitem__/append/map over values.
"""

from __future__ import annotations

from typing import Any, Dict, Union


class SliceWrapper:
    def __init__(self, data: Union[Dict[str, Any], Any]):
        self.data = data

    def _is_dict(self) -> bool:
        return isinstance(self.data, dict)

    def __getitem__(self, index):
        if self._is_dict():
            return {k: v[index] for k, v in self.data.items()}
        return self.data[index]

    def __len__(self):
        if self._is_dict():
            lengths = {len(v) for v in self.data.values()}
            assert len(lengths) <= 1, "Inconsistent lengths in SliceWrapper dict"
            return lengths.pop() if lengths else 0
        return len(self.data)

    def append(self, other):
        """Append a value to each list in the wrapped dict (or the list)."""
        if self._is_dict():
            if isinstance(other, SliceWrapper):
                other = other.data
            for k, v in other.items():
                self.data.setdefault(k, []).append(v)
        else:
            self.data.append(other)

    def extend(self, other):
        if self._is_dict():
            if isinstance(other, SliceWrapper):
                other = other.data
            for k, v in other.items():
                self.data.setdefault(k, []).extend(v)
        else:
            self.data.extend(other)

    def map(self, fn):
        if self._is_dict():
            return SliceWrapper({k: fn(v) for k, v in self.data.items()})
        return SliceWrapper(fn(self.data))

    @property
    def shape(self):
        """Common leading shape of wrapped values (longest shared prefix)."""
        if self._is_dict():
            shapes = [v.shape for v in self.data.values()]
            if not shapes:
                return ()
            prefix = []
            for dims in zip(*shapes):
                if all(d == dims[0] for d in dims):
                    prefix.append(dims[0])
                else:
                    break
            return tuple(prefix)
        return self.data.shape

    def keys(self):
        assert self._is_dict()
        return self.data.keys()

    def items(self):
        assert self._is_dict()
        return self.data.items()

    def values(self):
        assert self._is_dict()
        return self.data.values()
