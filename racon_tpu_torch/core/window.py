"""Window: the unit of POA consensus.

A window is a `window_length` slice of a target contig (the backbone) plus the
read slices (layers) that overlap it. Behavioral contract (reference
src/window.cpp):
  - backbone is sequence 0 with position (0, 0) (window.cpp:29-37);
  - empty layers or begin == end layers are ignored (window.cpp:45-47);
  - invalid layer positions are fatal (window.cpp:54-58);
  - fewer than 3 total sequences -> consensus = backbone, "not polished"
    (window.cpp:68-71);
  - layers are processed sorted by begin position (window.cpp:84-85);
  - TGS windows trim consensus ends where coverage < (n_seqs - 1) / 2 and
    warn about chimerism when nothing survives (window.cpp:118-139).

Unlike the reference (whose Window owns spoa calls), consensus generation
here is batched: the polisher packs many windows into fixed-shape tensors
and runs the POA engine (ops/poa.py) over all of them at once — the
analogue of GenomeWorks cudapoa batches (src/cuda/cudabatch.cpp).
"""

from __future__ import annotations

import enum

from ..errors import RaconError
from ..utils.logger import warn_dedup


class WindowType(enum.Enum):
    kNGS = 0   # short reads (mean length <= 1000)
    kTGS = 1   # long reads


class Window:
    __slots__ = ("id", "rank", "type", "consensus", "sequences", "qualities",
                 "positions", "polished")

    def __init__(self, id_: int, rank: int, type_: WindowType,
                 backbone: bytes, quality: bytes):
        self.id = id_            # target sequence index
        self.rank = rank         # window index within the target
        self.type = type_
        self.consensus = b""
        self.polished = False
        # layer 0 is the backbone
        self.sequences: list[bytes] = [backbone]
        self.qualities: list[bytes | None] = [quality]
        self.positions: list[tuple[int, int]] = [(0, 0)]

    def add_layer(self, sequence: bytes, quality: bytes | None,
                  begin: int, end: int) -> None:
        if len(sequence) == 0 or begin == end:
            return
        if quality is not None and len(sequence) != len(quality):
            raise RaconError("Window.add_layer", "unequal quality size!")
        backbone_len = len(self.sequences[0])
        if begin >= end or begin > backbone_len or end > backbone_len:
            raise RaconError("Window.add_layer",
                             "layer begin and end positions are invalid!")
        self.sequences.append(sequence)
        self.qualities.append(quality)
        self.positions.append((begin, end))

    @property
    def num_layers(self) -> int:
        return len(self.sequences) - 1

    def backbone_fallback(self) -> None:
        """Use the unpolished backbone as consensus (reference window.cpp:68-71)."""
        self.consensus = self.sequences[0]
        self.polished = False

    def sorted_layer_order(self) -> list[int]:
        """Layer indices (1-based into sequences) sorted by begin position,
        stable — reference window.cpp:78-85."""
        return sorted(range(1, len(self.sequences)),
                      key=lambda i: self.positions[i][0])

    def apply_trim(self, consensus: bytes, coverages, trim: bool = True) -> None:
        """Post-consensus coverage trim for TGS windows (window.cpp:118-139)."""
        self.consensus = consensus
        self.polished = True
        if self.type != WindowType.kTGS or not trim:
            return
        average_coverage = (len(self.sequences) - 1) // 2
        begin, end = 0, len(consensus) - 1
        while begin < len(consensus) and coverages[begin] < average_coverage:
            begin += 1
        while end >= 0 and coverages[end] < average_coverage:
            end -= 1
        if begin >= end:
            # one line per run, not one per suspect window (a noisy draft
            # can trip this on hundreds of windows); debug shows each
            warn_dedup(
                "Window.chimeric",
                f"[racon_tpu_torch::Window.generate_consensus] warning: "
                f"contig {self.id} might be chimeric in window "
                f"{self.rank}!")
        else:
            self.consensus = consensus[begin:end + 1]


def create_window(id_: int, rank: int, type_: WindowType, backbone: bytes,
                  quality: bytes) -> Window:
    """Factory mirroring reference createWindow (window.cpp:15-27)."""
    if len(backbone) == 0 or len(backbone) != len(quality):
        raise RaconError("create_window",
                         "empty backbone sequence/unequal quality length!")
    return Window(id_, rank, type_, backbone, quality)
