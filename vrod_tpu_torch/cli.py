"""CLI entry point of the PyTorch port — the JAX package's CLI, forked.

Run as ``python -m vrod_tpu_torch.cli``: the same flags, verbs and on-disk
databases as ``python -m vrod_tpu.cli``, served by the port's engine on the
device ``VROD_PLATFORM`` names (default ``cuda:0``). ``--serve`` raises: the
server (and the replication flags that go with it) is ROADMAP Queue 1
item 5.

Flags mirror ``src/main.rs:10-34``:
  --init-database PATH, --init-database-name/-n NAME, --database/-d DIR,
  --collection/-c NAME, --execute/-e COMMAND, --command-arg/-a ARG,
  --generate-embeddings/-g AMOUNT.
No args prints help (arg_required_else_help, main.rs:11). Unlike the
reference — where the execute path is commented out (main.rs:64-74) — this
CLI routes --execute through the CommandBuilder against a loaded database,
falling back to the current working directory when --database is omitted
(the reference's stated intent).
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

from .commands import CommandBuilder
from .database import Database
from .errors import MissingInitDatabaseNameError, VrodError


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="vrod",
        description="vrod-tpu (PyTorch/CUDA port): an exact-kNN vector "
                    "store",
    )
    p.add_argument("-i", "--init-database", metavar="PATH",
                   help="initialize a new database under PATH")
    p.add_argument("-n", "--init-database-name", metavar="NAME",
                   help="name of the database to initialize")
    p.add_argument("-d", "--database", metavar="DIR",
                   help="database directory (default: current directory)")
    p.add_argument("-c", "--collection", metavar="COLLECTION_NAME",
                   help="target collection for the command")
    p.add_argument("-e", "--execute", metavar="COMMAND",
                   help="command verb to execute (case-insensitive): CREATE, "
                        "DROP, LISTCOLLECTIONS, TRUNCATEWAL, INSERT, "
                        "BULKINSERT, UPDATE, DELETE, SEARCH, SEARCHSIMILAR, "
                        "REINDEX; extension: EXPORT (dump records to a file, "
                        "BULKINSERT's inverse)")
    p.add_argument("-a", "--command-arg", metavar="COMMAND_ARG",
                   help="argument for the command")
    p.add_argument("-g", "--generate-embeddings", metavar="AMOUNT", type=int,
                   help="development utility: embed the first AMOUNT words of "
                        "a sample text and write alice_embeddings.txt "
                        "(reference: src/utils/embeddings.rs). Uses a local "
                        "model if VROD_EMBED_MODEL (or ./.vrod_embed_model) "
                        "points at a transformers dir / torch .pt / .onnx; "
                        "otherwise the builtin hash embedder")
    p.add_argument("--shell", action="store_true",
                   help="interactive mode: load the database once and read "
                        "'VERB [-c COLLECTION] [-a ARG]' lines from stdin "
                        "(amortizes startup and kernel builds across "
                        "commands)")
    p.add_argument("--serve", metavar="ADDR",
                   help="not yet ported to vrod_tpu_torch: serve with "
                        "python -m vrod_tpu.cli --serve")
    from .config import VROD_VERSION
    p.add_argument("-V", "--version", action="version",
                   version=f"vrod-tpu {VROD_VERSION}")
    return p


_VALUE_FLAGS = {
    "-i": "--init-database", "-n": "--init-database-name", "-d": "--database",
    "-c": "--collection", "-e": "--execute", "-a": "--command-arg",
    "-g": "--generate-embeddings",
}


def _preprocess(argv):
    """Join value flags with their argument (``-a v`` -> ``--command-arg=v``)
    so values beginning with '-' (negative vector components) parse cleanly."""
    out, i = [], 0
    long_flags = set(_VALUE_FLAGS.values())
    while i < len(argv):
        tok = argv[i]
        if (tok in _VALUE_FLAGS or tok in long_flags) and i + 1 < len(argv):
            long = _VALUE_FLAGS.get(tok, tok)
            out.append(f"{long}={argv[i + 1]}")
            i += 2
        else:
            out.append(tok)
            i += 1
    return out


def _shell(db, default_collection=None, stdin=None, stdout=None,
           stderr=None) -> int:
    """Interactive command loop: ``VERB [-c COLLECTION] [-a ARG]`` per line
    (shlex rules, so quoted args may contain spaces). ``exit``/``quit``/EOF
    ends the session; errors print to stderr and the loop continues.
    Scripted use (piped stdin) exits 1 if any command failed, so pipelines
    can detect failures; interactively the exit code stays 0 (errors were
    already seen and handled at the prompt)."""
    import shlex

    stdin = stdin if stdin is not None else sys.stdin
    stdout = stdout if stdout is not None else sys.stdout
    stderr = stderr if stderr is not None else sys.stderr
    interactive = stdin.isatty()
    builder = CommandBuilder(db)
    failed = False
    if interactive:
        print(f"vrod shell — database {db.path} "
              f"(verbs are case-insensitive; 'exit' to quit)", file=stdout)
    while True:
        if interactive:
            stdout.write("vrod> ")
            stdout.flush()
        line = stdin.readline()
        if not line:
            break
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        if line.lower() in ("exit", "quit"):
            break
        try:
            toks = shlex.split(line)
            verb, collection, arg = toks[0], default_collection, None
            i = 1
            while i < len(toks):
                if toks[i] in ("-c", "--collection") and i + 1 < len(toks):
                    collection = toks[i + 1]
                    i += 2
                elif toks[i] in ("-a", "--command-arg") and i + 1 < len(toks):
                    arg = toks[i + 1]
                    i += 2
                else:
                    raise VrodError(
                        f"Unexpected shell token {toks[i]!r}; usage: "
                        "VERB [-c COLLECTION] [-a ARG]")
            print(builder.build(collection, verb, arg).execute(),
                  file=stdout)
        except (VrodError, ValueError) as e:  # ValueError: shlex errors
            print(f"Error: {e}", file=stderr)
            failed = True
    return 1 if (failed and not interactive) else 0


def main(argv=None) -> int:
    try:
        rc = _main(argv)
        # Flush NOW, inside the EPIPE guard: small outputs sit in the
        # stdio buffer until interpreter-exit flush, which would surface
        # a broken pipe as an unhandled 'Exception ignored' + exit 120
        # instead of routing through the handler below.
        sys.stdout.flush()
        return rc
    except BrokenPipeError:
        # Downstream closed early (`vrod ... | head`): exit like a unix
        # tool (128+SIGPIPE), not with a traceback. stdout is dead — point
        # it at devnull so interpreter shutdown's flush doesn't re-raise.
        import os
        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        return 141


def _main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(_preprocess(
        list(argv) if argv is not None else sys.argv[1:]))

    # No-args behavior matches arg_required_else_help (main.rs:11).
    if argv is not None and len(argv) == 0 or (argv is None and len(sys.argv) == 1):
        parser.print_help()
        return 2

    try:
        # Dev-only embedding generator runs first and exits (main.rs:46-49).
        if args.generate_embeddings is not None:
            from .utils.embeddings import process_embeddings
            process_embeddings(args.generate_embeddings)
            return 0

        # Init path (main.rs:51-62).
        if args.init_database is not None:
            if args.init_database_name is None:
                raise MissingInitDatabaseNameError()
            db = Database.new(args.init_database, args.init_database_name)
            db.close()
            print(f"Initialized database at {Path(args.init_database) / args.init_database_name}")
            return 0

        # Interactive shell: one long-lived Database + compiled programs
        # serving many commands (the one-shot CLI pays JAX init per verb).
        if args.shell:
            db_dir = Path(args.database) if args.database else Path.cwd()
            with Database.load(db_dir) as db:
                return _shell(db, default_collection=args.collection)

        if args.serve:
            raise VrodError(
                "--serve is not yet ported to vrod_tpu_torch (ROADMAP "
                "Queue 1 item 5); serve with python -m vrod_tpu.cli")

        # Execute path — the reference's intended (dormant) wiring
        # (main.rs:64-74 + builder.rs).
        if args.execute is not None:
            db_dir = Path(args.database) if args.database else Path.cwd()
            with Database.load(db_dir) as db:
                cmd = CommandBuilder(db).build(
                    args.collection, args.execute, args.command_arg)
                print(cmd.execute())
            return 0

        parser.print_help()
        return 2
    except VrodError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    raise SystemExit(main())
