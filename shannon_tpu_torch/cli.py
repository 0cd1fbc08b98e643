"""CLI of the PyTorch/CUDA port: the argument surface of ``shannon_tpu.cli``
plus ``--device``.

    shannon-tpu-torch -o OUT --single reads.fasta -K 24
    shannon-tpu-torch -o OUT --left l.fastq --right r.fastq --device cuda
    shannon-tpu-torch -o OUT --single reads.fasta --backend oracle
    python -m shannon_tpu_torch.cli ...

Runs :func:`shannon_tpu_torch.pipeline.run_pipeline`.  ``--backend device``
(the default) runs on ``--device`` (cuda unless asked for cpu); ``--backend
oracle`` runs the pure-Python oracle on the host, as the reference's
``--backend oracle`` does.  ``-p N`` counts in N shards of one process.
Under torchrun the device backend runs as one rank of a process group
(``parallel.multihost.init_distributed``), each rank on its share of the
input, with an explicit ``--read-pad-length`` for byte-range ingest:

    python -m torch.distributed.run --nproc-per-node N -m shannon_tpu_torch.cli \
        -o OUT --single reads.fasta --read-pad-length 128

The oracle backend joins no process group, as in the reference.
"""

from __future__ import annotations

import argparse
import contextlib
import sys

from shannon_tpu_torch.config import AssemblyConfig


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="shannon-tpu-torch",
        description="de novo RNA-seq transcriptome assembler (PyTorch/CUDA port)",
    )
    p.add_argument("-o", "--out-dir", required=True, help="output directory")
    src = p.add_argument_group("input (single OR paired)")
    src.add_argument("--single", help="single-end reads (FASTA/FASTQ, .gz ok)")
    src.add_argument("--left", help="paired-end left/mate-1 reads")
    src.add_argument("--right", help="paired-end right/mate-2 reads")
    p.add_argument("-K", "-k", "--kmer-size", type=int, default=24, dest="k")
    p.add_argument(
        "-p", "--partitions", type=int, default=0,
        help="shards to count across (0 = every visible card); shards beyond "
        "the cards share them round robin",
    )
    p.add_argument("--ss", "--strand-specific", action="store_true",
                   dest="strand_specific", help="strand-specific protocol")
    p.add_argument("--min-abundance", type=int, default=0,
                   help="drop k-mers below this count; 0 (default) = "
                        "auto from the count histogram")
    p.add_argument("--sibling-ratio", type=float, default=0.1,
                   help="error-branch pruning ratio (0 disables)")
    p.add_argument(
        "--error-branch-ratio", type=float,
        default=AssemblyConfig.error_branch_ratio,
        help="stricter pruning ratio for branches at the single-error "
             "footprint length <= k+2 (0 disables)",
    )
    p.add_argument("--min-transcript-length", type=int, default=200)
    p.add_argument(
        "--no-pairs", action="store_true",
        help="ignore paired-end mate/insert-size evidence in "
             "multibridging (pairs are used by default)",
    )
    p.add_argument(
        "--insert-size", type=int, default=AssemblyConfig.insert_size,
        help="mean fragment (insert) length of the paired library; "
             "0 = estimate from the data",
    )
    p.add_argument(
        "--insert-size-std", type=float,
        default=AssemblyConfig.insert_size_std,
        help="fragment length standard deviation; 0 = estimate "
             "(1.4826*MAD, or 10%% of --insert-size when given)",
    )
    p.add_argument("--kmer-capacity", type=int, default=1 << 22,
                   help="device spectrum table capacity")
    p.add_argument("--read-pad-length", type=int, default=0,
                   help="device read padding; 0 = auto-size to the "
                        "longest read (32-base grid, never truncates)")
    p.add_argument("--no-resume", action="store_true",
                   help="recompute every stage even if artifacts exist")
    p.add_argument("--backend", choices=["device", "oracle"], default="device",
                   help="'oracle' = pure-Python reference-semantics path on the host")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; no CPU "
                        "fallback: cuda without a card raises)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--min-output-abundance", type=float,
        default=AssemblyConfig.min_output_abundance,
    )
    p.add_argument("--profile", action="store_true",
                   help="write a torch.profiler trace to OUT/profile "
                   "(open with TensorBoard or Perfetto)")
    return p


def _profiler(out_dir: str, device: str):
    """torch.profiler over the run, its trace written to OUT/profile."""
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(f"{out_dir}/profile"),
    )


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    if bool(args.single) == bool(args.left or args.right):
        print("error: provide exactly one of --single or --left/--right",
              file=sys.stderr)
        return 2
    if bool(args.left) != bool(args.right):
        print("error: --left and --right must be given together",
              file=sys.stderr)
        return 2
    config = AssemblyConfig(
        k=args.k,
        min_abundance=args.min_abundance,
        strand_specific=args.strand_specific,
        sibling_ratio=args.sibling_ratio,
        error_branch_ratio=args.error_branch_ratio,
        min_transcript_length=args.min_transcript_length,
        min_output_abundance=args.min_output_abundance,
        use_pairs=not args.no_pairs,
        insert_size=args.insert_size,
        insert_size_std=args.insert_size_std,
        kmer_capacity=args.kmer_capacity,
        read_pad_length=args.read_pad_length,
        out_dir=args.out_dir,
        n_devices=args.partitions,
        resume=not args.no_resume,
        seed=args.seed,
    )
    from shannon_tpu_torch import pipeline
    from shannon_tpu_torch.parallel.multihost import init_distributed, leave_distributed

    if args.backend == "device":
        init_distributed(args.device)
    traced = args.device if args.backend == "device" else "cpu"
    profiler = _profiler(args.out_dir, traced) if args.profile else contextlib.nullcontext()
    try:
        with profiler:
            result = pipeline.run_pipeline(
                config, single=args.single, left=args.left, right=args.right,
                backend=args.backend, device=args.device,
            )
    finally:
        leave_distributed()
    print(
        f"done: {len(result.transcripts)} transcripts -> "
        f"{config.out_dir}/transcripts.fasta"
    )
    for k, v in sorted(result.stats.items()):
        print(f"  {k}: {v}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
