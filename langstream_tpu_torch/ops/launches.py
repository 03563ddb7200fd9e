"""Count the port's kernels as the card ran them.

Each kernel wrapper counts, in Python, the launches it enqueues. A kernel
enqueued while a CUDA graph captures runs again on every replay of the
graph, where no Python runs, so those counts say nothing of a replayed
step. Each kernel also counts itself on the card: the first thread of its
grid adds one to a device counter of its form (``count_launch`` in each
``csrc/*.cu``), on a replay as on an eager launch. :func:`device_launches`
reads those counters around a block, under the wrappers' names:

- ``flash_prefill.cu``: ``flash_prefill`` (B1), ``flash_prefill_quant`` (B4);
- ``flash_decode.cu``: ``flash_decode`` (B2), ``flash_decode_quant`` (B5);
- ``paged_attention.cu``: ``paged_attention`` (B3),
  ``paged_attention_quant`` (B6), ``paged_attention_ragged_q`` (B7),
  ``paged_attention_ragged_q_quant`` (B8).

B3 and B6 run a decode step (one q token per slot), a prefill call (a
bucket of them) and a speculative verify step (1 + k of them). With
``shapes``, the counts also hold ``paged_attention/prefill`` and
``paged_attention_quant/prefill``: the launches of those two with more
than one q token per slot that are not verify blocks; and
``paged_attention/verify`` and ``paged_attention_quant/verify``: the
verify launches (``verify=True`` at the wrapper). Each is counted on the
card by a counter of its own (:data:`SHAPES`).
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Dict, Iterator

from langstream_tpu_torch.ops import _build

# library -> its kernel forms, in the order of its device counters
FORMS = {
    "flash_prefill": ("flash_prefill", "flash_prefill_quant"),
    "flash_decode": ("flash_decode", "flash_decode_quant"),
    "paged_attention": ("paged_attention", "paged_attention_quant",
                        "paged_attention_ragged_q", "paged_attention_ragged_q_quant",
                        "paged_attention/prefill", "paged_attention_quant/prefill",
                        "paged_attention/verify", "paged_attention_quant/verify"),
}
# counters of a kernel's launches at one shape, counted besides its total
SHAPES = ("paged_attention/prefill", "paged_attention_quant/prefill",
          "paged_attention/verify", "paged_attention_quant/verify")
KERNEL_NAMES = tuple(name for forms in FORMS.values() for name in forms if name not in SHAPES)


def read(reset: bool = False, shapes: bool = False) -> Dict[str, int]:
    """Every kernel form's launches on the card since its library was
    loaded or last reset (0 for a library not loaded in this process),
    after the device's queued work; ``reset`` zeroes them. ``shapes``
    adds the counts of :data:`SHAPES`."""
    names = KERNEL_NAMES + (SHAPES if shapes else ())
    counts = dict.fromkeys(names, 0)
    for library, forms in FORMS.items():
        lib = _build.loaded(library)
        if lib is None:
            continue
        values = (ctypes.c_ulonglong * len(forms))()
        _build.check(getattr(lib, f"{library}_launch_counts")(values, int(reset)),
                     f"{library}_launch_counts")
        counts.update((name, n) for name, n in zip(forms, values) if name in counts)
    return counts


@contextlib.contextmanager
def device_launches(shapes: bool = False) -> Iterator[Dict[str, int]]:
    """Yields a dict that, once the block has ended, holds every kernel
    form's launches on the card during the block (each name of
    :data:`KERNEL_NAMES`, and with ``shapes`` of :data:`SHAPES`). Waits
    for the device at both ends; another thread's kernels in the block
    count too."""
    read(reset=True)
    counts = dict.fromkeys(KERNEL_NAMES + (SHAPES if shapes else ()), 0)
    yield counts
    counts.update(read(shapes=shapes))
