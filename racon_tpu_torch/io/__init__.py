from .parsers import (
    MhapParser,
    PafParser,
    SamParser,
    create_sequence_parser,
    create_overlap_parser,
)

__all__ = [
    "MhapParser",
    "PafParser",
    "SamParser",
    "create_sequence_parser",
    "create_overlap_parser",
]
