"""`python -m racon_tpu_torch.native [--debug] [--force]`: build the host
library ahead of time (it otherwise builds at first use) and print its
path. `--debug` builds the ASan + UBSan variant (the reference's
sanitizer target, Makefile:23-25) into its own file; `--force` builds
again even when a build of these sources exists."""

import argparse
import sys

from . import build


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m racon_tpu_torch.native")
    ap.add_argument("--debug", action="store_true",
                    help="ASan + UBSan debug build "
                         "(libracon_host_debug-<key>.so)")
    ap.add_argument("--force", action="store_true",
                    help="build again even if a build exists")
    args = ap.parse_args(argv)
    print(build(force=args.force, debug=args.debug))
    return 0


if __name__ == "__main__":
    sys.exit(main())
