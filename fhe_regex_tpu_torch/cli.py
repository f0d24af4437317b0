"""CLI: ``fhe-regex-tpu-torch '<content>' '/<pattern>/'``.

Mirrors the reference binary (src/main.rs): pre-parses the pattern for an
early error, then runs keygen -> encrypt -> has_match -> decrypt and prints
``res: 0|1`` (``--count``: the number of matching offsets; ``--positions``:
one bit per start offset; ``--long``: windowed matching; ``--multivalue``:
shared blind rotations; ``--engine``: the circuit compiler).  Logging level via FHE_REGEX_LOG (analog of RUST_LOG,
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
                    help="parameter set name (default: TPU_MESSAGE_2_CARRY_2; "
                         "64-bit torus: TPU64_MESSAGE_2_CARRY_2)")
    ap.add_argument("--trivial", action="store_true",
                    help="use noiseless trivial content encryption (fast test path)")
    ap.add_argument("--fold", default="reference", choices=["reference", "tree"],
                    help="OR-fold order: reference (counter parity) or tree "
                         "(log-depth, lower latency)")
    ap.add_argument("--engine", default=None, choices=["python", "native"],
                    help="circuit compiler (default: native C++ if built)")
    ap.add_argument("--seed", type=int, default=None, help="keygen seed")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; an error without a "
                         "CUDA device, so pass --device cpu for the plain "
                         "CPU path)")
    ap.add_argument("--backend", default=None, choices=list(BACKENDS),
                    help="blind rotation (default on a CUDA device: the "
                         "cuda-fused kernel at 32 bits, cuda64-bg at 64; "
                         "elsewhere torch / torch64)")
    ap.add_argument("--branch-budget", type=int, default=None,
                    help="cap on circuit branch expansion (clean error "
                         "instead of unbounded compile time)")
    ap.add_argument("--multivalue", action="store_true",
                    help="share blind rotations between same-input ops "
                         "(multi-value bootstrap)")
    ap.add_argument("--count", action="store_true",
                    help="print the NUMBER of matching offsets instead of 0/1")
    ap.add_argument("--positions", action="store_true",
                    help="print one 0/1 per start offset instead of the "
                         "global match bit")
    ap.add_argument("--long", dest="long_", action="store_true",
                    help="windowed long-content matching (fixed circuit "
                         "shape for any content length)")
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
        BranchBudgetExceeded, count_matches, decrypt, decrypt_count,
        encrypt_str, gen_keys, get_params, has_match, has_match_long,
        has_match_positions, trivial_encrypt_str,
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
    kw = dict(backend=args.backend, fold=args.fold,
              branch_budget=args.branch_budget, device=args.device)
    try:
        if args.count:
            if args.multivalue:
                # counting LUT factors fail the mv sigma-margin check, so
                # count_matches always compiles classic: say so instead of
                # ignoring the flag (as the JAX package's CLI does)
                print("error: --multivalue is not supported with --count "
                      "(counting LUTs fail the multi-value noise-margin "
                      "check; the count circuit always compiles classic)",
                      file=sys.stderr)
                return 2
            ct_res = count_matches(server_key, ct_content, args.pattern, **kw)
            print(f"count: {decrypt_count(client_key, ct_res)}")
            return 0
        kw.update(engine=args.engine, multivalue=args.multivalue or None)
        if args.positions:
            ct_res = has_match_positions(server_key, ct_content, args.pattern,
                                         **kw)
            bits = "".join(str(decrypt(client_key, r)) for r in ct_res)
            print(f"positions: {bits}")
            return 0
        match = has_match_long if args.long_ else has_match
        ct_res = match(server_key, ct_content, args.pattern, **kw)
    except BranchBudgetExceeded as e:
        print(f"error: {e}", file=sys.stderr)
        return 3
    except (ValueError, RuntimeError) as e:   # backend/device mismatches
        print(f"error: {e}", file=sys.stderr)
        return 2
    print(f"res: {decrypt(client_key, ct_res)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
