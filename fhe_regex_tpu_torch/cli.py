"""CLI: ``fhe-regex-tpu-torch '<content>' '/<pattern>/'``.

Mirrors the reference binary (src/main.rs): pre-parses the pattern for an
early error, then runs keygen -> encrypt -> has_match -> decrypt and prints
``res: 0|1``.  Logging level via FHE_REGEX_LOG (analog of RUST_LOG,
main.rs:10-11); defaults to info.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys


def main(argv=None) -> int:
    from fhe_regex_tpu_torch.ops.pbs import BACKENDS

    ap = argparse.ArgumentParser(
        prog="fhe-regex-tpu-torch",
        description="Match a regex against encrypted content (TFHE on "
                    "PyTorch/CUDA).",
    )
    ap.add_argument("content", help="plaintext content to encrypt and search")
    ap.add_argument("pattern", help="pattern, e.g. '/^ab?c$/i'")
    ap.add_argument("--params", default=None,
                    help="parameter set name (default: TPU_MESSAGE_2_CARRY_2)")
    ap.add_argument("--trivial", action="store_true",
                    help="use noiseless trivial content encryption (fast test path)")
    ap.add_argument("--fold", default="reference", choices=["reference", "tree"],
                    help="OR-fold order: reference (counter parity) or tree "
                         "(log-depth, lower latency)")
    ap.add_argument("--seed", type=int, default=None, help="keygen seed")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda if available, else cpu)")
    ap.add_argument("--backend", default=None, choices=list(BACKENDS),
                    help="blind rotation (default: cuda-fused kernel on a "
                         "CUDA device, torch otherwise)")
    args = ap.parse_args(argv)

    logging.basicConfig(
        level=os.environ.get("FHE_REGEX_LOG", "INFO").upper(),
        format="%(levelname)s %(name)s: %(message)s",
    )
    log = logging.getLogger("fhe_regex_tpu_torch.cli")

    from fhe_regex_tpu_torch.regex.parser import parse, ParseError
    try:
        re = parse(args.pattern)
    except ParseError as e:
        print(f"failed to parse: {e}", file=sys.stderr)
        return 2
    log.info("parsed: %r", re)

    from fhe_regex_tpu_torch import (
        BranchBudgetExceeded, decrypt, encrypt_str, gen_keys, get_params,
        has_match, trivial_encrypt_str,
    )

    params = get_params(args.params)
    log.info("generating keys (%s)..", params.name)
    client_key, server_key = gen_keys(params, seed=args.seed)

    log.info("encrypting content..")
    try:
        ct_content = (trivial_encrypt_str(params, args.content) if args.trivial
                      else encrypt_str(client_key, args.content))
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    log.info("applying regex..")
    try:
        ct_res = has_match(server_key, ct_content, args.pattern,
                           backend=args.backend, fold=args.fold,
                           device=args.device)
    except BranchBudgetExceeded as e:
        print(f"error: {e}", file=sys.stderr)
        return 3
    except ValueError as e:   # argument errors (backend/device mismatches)
        print(f"error: {e}", file=sys.stderr)
        return 2
    print(f"res: {decrypt(client_key, ct_res)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
