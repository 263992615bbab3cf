"""Command line of the PyTorch port: the reference's numbered scripts and
serving as subcommands.

    python -m visual_onoma_to_wave_tpu_torch.cli format      <config> <audio_dir>
    python -m visual_onoma_to_wave_tpu_torch.cli prepare-tg  <config>
    python -m visual_onoma_to_wave_tpu_torch.cli preprocess  <config> [--device cpu]
    python -m visual_onoma_to_wave_tpu_torch.cli train       <config> [--restore-step N]
        [--max-steps N] [--vocoder voc.npz] [--loader-workers N] [--device cpu]
    python -m visual_onoma_to_wave_tpu_torch.cli evaluate    <config> [--restore-step N]
        [--metrics] [--vocoder voc.npz] [--device cpu]
    python -m visual_onoma_to_wave_tpu_torch.cli synthesize \\
        examples/checkpoints/demo/config.json \\
        --acoustic examples/checkpoints/demo/torch/acoustic.npz \\
        --vocoder examples/checkpoints/demo/torch/vocoder.npz \\
        --text パンパン --audiotype drum --out out.wav
    python -m visual_onoma_to_wave_tpu_torch.cli synthesize-batch <config> <rows> <out_dir> \
        --acoustic acoustic.npz --vocoder vocoder.npz [--batch-size 16] [--device cpu]
    python -m visual_onoma_to_wave_tpu_torch.cli serve <config> --acoustic ... [--vocoder ...]
    python -m visual_onoma_to_wave_tpu_torch.cli serve --exported <artifact_dir> [--device cpu]
    python -m visual_onoma_to_wave_tpu_torch.cli export <config> --acoustic ... --vocoder ...
        --out <artifact_dir> [--max-batch 8] [--text-lens 4,8] [--devices cuda,cpu]
    python -m visual_onoma_to_wave_tpu_torch.cli demo <config> [--acoustic acoustic.npz |
        --restore-step N] [--vocoder vocoder.npz] [--host 127.0.0.1] [--port 7860]
    python -m visual_onoma_to_wave_tpu_torch.cli train-vocoder <wav_dir> <out_dir>
        [--steps N] [--family hifigan|...] [--disc msd|mrd] [--ema-decay D] [--device cpu]

Weights are `.npz` trees: those written by `examples/export_demo_for_torch.py`,
a training checkpoint's `<ckpt>/<step>/acoustic.npz`, or a vocoder checkpoint's
`<out_dir>/<step>/generator.npz` (`train-vocoder`). Configs load through
`config.load_config` (JSON, YAML or the reference's three-YAML directory).
Every command that computes runs on `cuda` unless `--device cpu` is given.
`train`, `evaluate` and `train-vocoder` take `--distributed` (with
`--coordinator host:port --num-processes N --process-id I`, or torchrun's
environment): every process runs the same command, data-parallel over the
processes (gloo on the CPU, nccl on the card, one card per process).
"""
from __future__ import annotations

import argparse
import json
import pathlib


def cmd_synthesize(args) -> None:
    from visual_onoma_to_wave_tpu_torch.config import load_config
    from visual_onoma_to_wave_tpu_torch.data.audio_io import write_wav
    from visual_onoma_to_wave_tpu_torch.synthesis import Synthesizer

    cfg = load_config(args.config)
    synth = Synthesizer.from_checkpoint(cfg, acoustic=args.acoustic, vocoder=args.vocoder,
                                        device=args.device)
    rates = [float(x) for x in args.width_rates.split(",")] if args.width_rates else None
    result = synth.synthesize(args.text, args.audiotype, width_rates=rates,
                              e_control=args.e_control, d_control=args.d_control)
    print(f"mel frames: {result.mel.shape[0]}, durations: {result.durations.tolist()}")
    if result.wav is not None and args.out:
        write_wav(args.out, result.wav, cfg.audio.sampling_rate)
        print(f"wrote {args.out}")


def _read_batch_rows(path) -> list[dict]:
    """The rows of a batch-synthesis input file, each line in one of two
    formats: the preprocessed split format `name|audiotype|fontsize|font|text`
    (so train/val/test.txt work as they are), or TSV
    `text<TAB>audiotype[<TAB>d_control[<TAB>e_control]]`. Blank lines and
    `#` comments are skipped. Returns dicts with name, text, audiotype, d, e."""
    rows = []
    with open(path, encoding="utf-8") as f:
        for ln, line in enumerate(f):
            line = line.rstrip("\n")
            if not line or line.startswith("#"):
                continue
            if "|" in line:
                parts = line.split("|")
                if len(parts) < 5:
                    raise ValueError(f"{path}:{ln + 1}: split-format rows need 5 |-separated "
                                     f"fields, got {len(parts)}")
                name, at, _fontsize, _font, text = parts[:5]
                rows.append({"name": name, "text": text, "audiotype": at, "d": 1.0, "e": 1.0})
            else:
                parts = line.split("\t")
                if len(parts) < 2:
                    raise ValueError(f"{path}:{ln + 1}: TSV rows need at least "
                                     "text<TAB>audiotype")
                rows.append({"name": f"{ln:05d}", "text": parts[0], "audiotype": parts[1],
                             "d": float(parts[2]) if len(parts) > 2 else 1.0,
                             "e": float(parts[3]) if len(parts) > 3 else 1.0})
    return rows


def cmd_synthesize_batch(args) -> int:
    """Offline corpus synthesis: every row of the input file -> a wav named
    after the row, in batches of --batch-size rows sorted by text length
    through the fused acoustic + vocoder call. Per-row controls are scaled
    by the global --d-control / --e-control; rows predicted 0 frames are
    skipped and counted."""
    import time

    from visual_onoma_to_wave_tpu_torch.config import load_config
    from visual_onoma_to_wave_tpu_torch.data.audio_io import write_wav
    from visual_onoma_to_wave_tpu_torch.synthesis import Synthesizer

    cfg = load_config(args.config)
    synth = Synthesizer.from_checkpoint(cfg, acoustic=args.acoustic, vocoder=args.vocoder,
                                        device=args.device)
    rows = _read_batch_rows(args.input)
    if not rows:
        print("no rows in input")
        return 1
    out_dir = pathlib.Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    # similar lengths share a batch: less padding
    order = sorted(range(len(rows)), key=lambda i: len(rows[i]["text"]))
    sr = cfg.audio.sampling_rate
    written, skipped, audio_sec = 0, 0, 0.0
    t0 = time.perf_counter()
    for c0 in range(0, len(order), args.batch_size):
        chunk = [rows[i] for i in order[c0:c0 + args.batch_size]]
        results = synth.synthesize_batch(
            [r["text"] for r in chunk], [r["audiotype"] for r in chunk],
            e_control=[r["e"] * args.e_control for r in chunk],
            d_control=[r["d"] * args.d_control for r in chunk], return_mel=False)
        for r, res in zip(chunk, results):
            if res.wav is None or res.mel_len == 0:
                skipped += 1
                continue
            name = "".join(ch if ch.isalnum() or ch in "-_." else "_" for ch in r["name"]) or "row"
            write_wav(out_dir / f"{name}.wav", res.wav, sr)
            written += 1
            audio_sec += res.wav.shape[0] / sr
    wall = time.perf_counter() - t0
    print(f"wrote {written} wavs ({audio_sec:.1f}s audio) to {out_dir} "
          f"in {wall:.1f}s ({audio_sec / max(wall, 1e-9):.1f}x realtime, "
          f"includes first-compile)"
          + (f"; {skipped} rows predicted 0 frames" if skipped else ""))
    return 0


def cmd_export(args) -> None:
    from visual_onoma_to_wave_tpu_torch.config import load_config
    from visual_onoma_to_wave_tpu_torch.export import export_synthesizer, validate_devices
    from visual_onoma_to_wave_tpu_torch.synthesis import Synthesizer

    # the cheap arguments first: 'cuda, bogus' must not fail after a slow load
    try:
        devices = validate_devices(args.devices.lower().split(","))
    except ValueError as e:
        raise SystemExit(f"--devices: {e}") from None
    kwargs = {}
    if args.text_lens:
        kwargs["text_lens"] = [int(v) for v in args.text_lens.split(",")]
    cfg = load_config(args.config)
    synth = Synthesizer.from_checkpoint(cfg, acoustic=args.acoustic, vocoder=args.vocoder,
                                        device=devices[0])
    manifest = export_synthesizer(synth, args.out, max_batch=args.max_batch, devices=devices,
                                  **kwargs)
    print(f"exported {len(manifest['buckets'])} buckets in one program per device "
          f"({','.join(devices)}) -> {args.out}")


def cmd_serve(args) -> None:
    from visual_onoma_to_wave_tpu_torch.serve import MAX_TEXT_LEN, BatchingServer

    if args.exported:
        from visual_onoma_to_wave_tpu_torch.export import ExportedSynthesizer

        ignored = [n for n, v in (("config", args.config), ("--acoustic", args.acoustic),
                                  ("--vocoder", args.vocoder)) if v is not None]
        if ignored:
            print(f"warning: serving the --exported artifact; {', '.join(ignored)} ignored "
                  "(the artifact holds its own weights and config)")
        synth = ExportedSynthesizer.load(args.exported, device=args.device)
        if synth.max_batch < args.max_batch:
            print(f"note: artifact ships batch buckets up to {synth.max_batch}; capping "
                  "--max-batch there")
            args.max_batch = synth.max_batch
        # the server enforces min(its own cap, the artifact's buckets): print that
        print(f"note: requests capped at {min(synth.max_text_len, MAX_TEXT_LEN)} characters "
              f"(artifact text buckets {synth.max_text_len}, server cap {MAX_TEXT_LEN})")
    else:
        from visual_onoma_to_wave_tpu_torch.config import load_config
        from visual_onoma_to_wave_tpu_torch.synthesis import Synthesizer

        if not args.config or not args.acoustic:
            raise SystemExit("serve: config and --acoustic are required (or pass --exported)")
        synth = Synthesizer.from_checkpoint(load_config(args.config), acoustic=args.acoustic,
                                            vocoder=args.vocoder, device=args.device)
    server = BatchingServer(synth, host=args.host, port=args.port,
                            max_batch=args.max_batch, batch_window_ms=args.window_ms,
                            max_queue=args.max_queue,
                            request_timeout_s=args.request_timeout,
                            pipeline_depth=args.pipeline_depth)
    server.serve_forever()


def acoustic_checkpoint(config, acoustic: str | None, restore_step: int | None) -> str:
    """`acoustic` if given, else the training checkpoint's
    `<path.ckpt>/<step>/acoustic.npz` at `restore_step` (None or -1: the latest)."""
    if acoustic is not None:
        return acoustic
    from visual_onoma_to_wave_tpu_torch.utils.checkpoint import ACOUSTIC, CheckpointManager

    ckpt = CheckpointManager(config.path.ckpt)
    step = ckpt.latest_step() if restore_step in (None, -1) else restore_step
    if step is None or step not in ckpt.all_steps():
        raise SystemExit(f"no --acoustic and no checkpoint at step {step} under {ckpt.dir}")
    return str(ckpt.dir / str(step) / ACOUSTIC)


def cmd_demo(args) -> None:
    from visual_onoma_to_wave_tpu_torch.config import load_config
    from visual_onoma_to_wave_tpu_torch.demo_server import DemoServer
    from visual_onoma_to_wave_tpu_torch.synthesis import Synthesizer

    cfg = load_config(args.config)
    synth = Synthesizer.from_checkpoint(
        cfg, acoustic=acoustic_checkpoint(cfg, args.acoustic, args.restore_step),
        vocoder=args.vocoder, device=args.device)
    DemoServer(synth, host=args.host, port=args.port).serve_forever()


def cmd_preprocess(args) -> None:
    from visual_onoma_to_wave_tpu_torch.config import load_config
    from visual_onoma_to_wave_tpu_torch.data.preprocess import Preprocessor

    cfg = load_config(args.config)
    result = Preprocessor(cfg, num_workers=args.num_workers, save_audio=args.save_audio,
                          device=args.device).build()
    print(json.dumps(result))


def cmd_format(args) -> None:
    from visual_onoma_to_wave_tpu_torch.config import load_config
    from visual_onoma_to_wave_tpu_torch.data.formatting import format_dataset

    counts = format_dataset(load_config(args.config), args.audio_dir,
                            missing_acc="keep" if args.keep_missing_acc else "skip")
    print(json.dumps(counts))


def cmd_prepare_tg(args) -> None:
    from visual_onoma_to_wave_tpu_torch.config import load_config
    from visual_onoma_to_wave_tpu_torch.data.labels import prepare_textgrids

    cfg = load_config(args.config)
    print(json.dumps(prepare_textgrids(cfg.path.formatted,
                                       list(cfg.dataset.extract_labels) or None)))


def _maybe_init_distributed(args) -> None:
    """Join the process group of a data-parallel run (train, evaluate,
    train-vocoder) before the trainer is built."""
    if getattr(args, "distributed", False):
        from visual_onoma_to_wave_tpu_torch.parallel import init_distributed

        init_distributed(coordinator_address=args.coordinator,
                         num_processes=args.num_processes, process_id=args.process_id,
                         device=args.device)


def _add_distributed_args(s) -> None:
    s.add_argument("--distributed", action="store_true",
                   help="join a data-parallel run over processes (torch.distributed: gloo "
                        "on the CPU, nccl on the card, one card per process); every "
                        "process runs this same command, and ckpt/log paths must be "
                        "shared storage")
    s.add_argument("--coordinator", default=None,
                   help="host:port of process 0 (default: torchrun's MASTER_ADDR/PORT)")
    s.add_argument("--num-processes", type=int, default=None)
    s.add_argument("--process-id", type=int, default=None)


def _trainer(args):
    _maybe_init_distributed(args)
    from visual_onoma_to_wave_tpu_torch.config import load_config
    from visual_onoma_to_wave_tpu_torch.synthesis import load_vocoder
    from visual_onoma_to_wave_tpu_torch.training.trainer import Trainer

    cfg = load_config(args.config)
    vocoder = load_vocoder(cfg, args.vocoder) if args.vocoder else None
    return Trainer(cfg, restore_step=args.restore_step, vocoder=vocoder, device=args.device,
                   loader_workers=getattr(args, "loader_workers", None))


def cmd_train(args) -> None:
    _trainer(args).train(max_steps=args.max_steps)


def cmd_evaluate(args) -> None:
    from visual_onoma_to_wave_tpu_torch.parallel import is_primary

    means = _trainer(args).evaluate(metrics=args.metrics)
    if is_primary():
        print(json.dumps(means))


# the generator families `train-vocoder` trains (the reference's choices)
VOCODER_FAMILIES = ("hifigan", "hifigan-v2", "hifigan-v3", "istftnet", "istftnet-mel", "vocos",
                    "bigvgan", "bigvgan-large")


def cmd_train_vocoder(args) -> None:
    """GAN-train a vocoder from a directory of wavs (the reference's
    `train-vocoder`): the family's recipe (`family_recipe`) unless --lr,
    --grad-clip or --disc say otherwise; checkpoints under out_dir. --bf16 is
    the mixed-precision GAN step (`VocoderTrainConfig.compute_dtype`)."""
    _maybe_init_distributed(args)
    from visual_onoma_to_wave_tpu_torch.models.hifigan_disc import MultiResolutionDiscriminator
    from visual_onoma_to_wave_tpu_torch.models.vocoder import get_vocoder
    from visual_onoma_to_wave_tpu_torch.precision import compute_dtype
    from visual_onoma_to_wave_tpu_torch.training.vocoder_trainer import (
        VocoderTrainConfig,
        VocoderTrainer,
        family_recipe,
        load_wav_dir,
    )

    recipe = family_recipe(args.family)
    cfg = VocoderTrainConfig(
        segment_size=args.segment_size, batch_size=args.batch_size,
        learning_rate=args.lr if args.lr is not None else recipe["learning_rate"],
        grad_clip_norm=args.grad_clip if args.grad_clip is not None else recipe["grad_clip_norm"],
        total_steps=args.steps, save_every=args.save_every, seed=args.seed,
        compute_dtype="bfloat16" if args.bf16 else "float32",
        ema_decay=args.ema_decay, on_divergence=args.on_divergence)
    disc = args.disc or recipe["disc"]
    clips = load_wav_dir(args.wav_dir, target_sr=cfg.sampling_rate)
    print(f"training {args.family} (MPD+{disc.upper()}) on {len(clips)} clips "
          f"({sum(len(c) for c in clips) / cfg.sampling_rate:.0f}s of audio) on {args.device}")
    dtype = compute_dtype(cfg.compute_dtype)
    trainer = VocoderTrainer(clips, cfg, gen=get_vocoder(args.family, dtype=dtype),
                             ckpt_dir=args.out_dir, log_dir=args.log_dir,
                             msd=(MultiResolutionDiscriminator(dtype=dtype) if disc == "mrd"
                                  else None),
                             device=args.device)
    if args.restore_step is not None:
        step = trainer.restore(args.restore_step if args.restore_step >= 0 else None)
        print(f"resumed from step {step}")
    trainer.train()
    print(f"vocoder checkpoints under {args.out_dir} (each step's generator.npz loads "
          "through synthesis.load_vocoder / --vocoder)")


def main(argv=None):
    p = argparse.ArgumentParser(prog="visual-onoma-to-wave-torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(s):
        s.add_argument("config")
        s.add_argument("--acoustic", required=True, help="acoustic weights (.npz)")
        s.add_argument("--vocoder", default=None, help="vocoder weights (.npz)")
        s.add_argument("--device", default="cuda",
                       help="torch device; 'cuda' fails when no GPU is visible")

    s = sub.add_parser("synthesize", help="text -> wav")
    common(s)
    s.add_argument("--text", required=True)
    s.add_argument("--audiotype", required=True)
    s.add_argument("--width-rates", default=None, help="comma-separated per-char width rates")
    s.add_argument("--e-control", type=float, default=1.0)
    s.add_argument("--d-control", type=float, default=1.0)
    s.add_argument("--out", default="out.wav")
    s.set_defaults(fn=cmd_synthesize)

    s = sub.add_parser("synthesize-batch",
                       help="offline corpus synthesis: split-file or TSV rows -> wav dir, "
                            "batched through the fused call")
    common(s)
    s.add_argument("input", help="rows: name|audiotype|fontsize|font|text (train/val/test.txt "
                                 "work directly) or text<TAB>audiotype[<TAB>d_control"
                                 "[<TAB>e_control]]")
    s.add_argument("out_dir")
    s.add_argument("--batch-size", type=int, default=16)
    s.add_argument("--e-control", type=float, default=1.0,
                   help="global multiplier on per-row e_control")
    s.add_argument("--d-control", type=float, default=1.0,
                   help="global multiplier on per-row d_control")
    s.set_defaults(fn=cmd_synthesize_batch)

    s = sub.add_parser("export", help="the fused serving step as a torch.export artifact")
    common(s)
    s.add_argument("--out", required=True, help="artifact directory")
    s.add_argument("--max-batch", type=int, default=8)
    s.add_argument("--text-lens", default=None,
                   help="comma-separated text-length buckets (default: 1 and 2 text buckets)")
    s.add_argument("--devices", default="cuda",
                   help="comma-separated devices of the artifact's programs (cuda, cpu); the "
                        "synthesizer loads on the first")
    s.set_defaults(fn=cmd_export)

    s = sub.add_parser("serve", help="JSON API with micro-batching")
    s.add_argument("config", nargs="?", default=None)
    s.add_argument("--acoustic", default=None, help="acoustic weights (.npz)")
    s.add_argument("--vocoder", default=None, help="vocoder weights (.npz)")
    s.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' fails when no GPU is visible")
    s.add_argument("--exported", default=None,
                   help="serve an `export` artifact directory (no checkpoint, no config)")
    s.add_argument("--host", default="127.0.0.1")
    s.add_argument("--port", type=int, default=7870)
    s.add_argument("--max-batch", type=int, default=32)
    s.add_argument("--window-ms", type=float, default=5.0)
    s.add_argument("--max-queue", type=int, default=1024)
    s.add_argument("--request-timeout", type=float, default=30.0)
    s.add_argument("--pipeline-depth", type=int, default=2)
    s.set_defaults(fn=cmd_serve)

    s = sub.add_parser("demo", help="interactive browser demo (prediction.ipynb GUI)")
    s.add_argument("config")
    s.add_argument("--vocoder", default=None, help="vocoder weights (.npz) for audio playback")
    s.add_argument("--acoustic", default=None,
                   help="acoustic weights (.npz); default: the training checkpoint under "
                        "path.ckpt at --restore-step")
    s.add_argument("--restore-step", type=int, default=None,
                   help="training checkpoint step without --acoustic (default: the latest)")
    s.add_argument("--host", default="127.0.0.1")
    s.add_argument("--port", type=int, default=7860)
    s.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' fails when no GPU is visible")
    s.set_defaults(fn=cmd_demo)

    s = sub.add_parser("preprocess", help="formatted corpus -> training features (03_preprocess)")
    s.add_argument("config")
    s.add_argument("--num-workers", type=int, default=None, help="host worker processes")
    s.add_argument("--save-audio", action="store_true",
                   help="also save mel-aligned trimmed waveforms under audio/")
    s.add_argument("--device", default="cuda",
                   help="torch device of the feature pass; 'cuda' fails when no GPU is visible")
    s.set_defaults(fn=cmd_preprocess)

    s = sub.add_parser("format", help="raw RWCP-SSD corpus -> formatted corpus (01_format)")
    s.add_argument("config")
    s.add_argument("audio_dir", help="root of the RWCP-SSD audio")
    s.add_argument("--keep-missing-acc", action="store_true",
                   help="write the rows of clips without an .acc file (others_score 0) "
                        "instead of skipping them")
    s.set_defaults(fn=cmd_format)

    s = sub.add_parser("prepare-tg", help="lab -> TextGrid and length stats (02_prepare_tg)")
    s.add_argument("config")
    s.set_defaults(fn=cmd_prepare_tg)

    def trained(s, what: str):
        s.add_argument("config")
        s.add_argument("--restore-step", type=int, default=None,
                       help="checkpoint step to start from (-1 = the latest)")
        s.add_argument("--vocoder", default=None,
                       help=f"vocoder weights (.npz) for {what}")
        s.add_argument("--device", default="cuda",
                       help="torch device; 'cuda' fails when no GPU is visible")

    s = sub.add_parser("train", help="train the acoustic model (04_train)")
    trained(s, "the sample synthesis's audio")
    s.add_argument("--max-steps", type=int, default=None)
    s.add_argument("--loader-workers", type=int, default=None,
                   help="batch-loader worker processes (default: min(10, cpus); <= 1 loads "
                        "in this process behind a prefetch thread)")
    _add_distributed_args(s)
    s.set_defaults(fn=cmd_train)

    s = sub.add_parser("evaluate", help="validation losses (evaluate.py)")
    trained(s, "the waveform metrics under --metrics (needs preprocess --save-audio)")
    s.add_argument("--metrics", action="store_true",
                   help="also teacher-forced mel_l1 and MCD, free-running DTW-MCD (dB)")
    _add_distributed_args(s)
    s.set_defaults(fn=cmd_evaluate)

    s = sub.add_parser("train-vocoder",
                       help="GAN-train a vocoder generator from a directory of wavs")
    s.add_argument("wav_dir", help="directory of .wav training clips")
    s.add_argument("out_dir", help="checkpoint output directory")
    s.add_argument("--steps", type=int, default=200_000)
    s.add_argument("--batch-size", type=int, default=16)
    s.add_argument("--segment-size", type=int, default=8192)
    s.add_argument("--lr", type=float, default=None,
                   help="generator / discriminator learning rate (default: the family's "
                        "recipe, 2e-4 HiFi-GAN, 1e-4 iSTFTNet and BigVGAN)")
    s.add_argument("--grad-clip", type=float, default=None,
                   help="global-norm gradient clip, 0 disables (default: the family's "
                        "recipe, off, 1e3 for iSTFTNet and BigVGAN)")
    s.add_argument("--save-every", type=int, default=10_000)
    s.add_argument("--seed", type=int, default=0)
    s.add_argument("--log-dir", default=None)
    s.add_argument("--restore-step", type=int, default=None,
                   help="resume from this checkpoint step (-1 = the latest)")
    s.add_argument("--family", default="hifigan", choices=VOCODER_FAMILIES,
                   help="generator family (hifigan is V1)")
    s.add_argument("--disc", default=None, choices=["msd", "mrd"],
                   help="the discriminator beside the MPD (default: mrd for bigvgan, msd "
                        "otherwise)")
    s.add_argument("--bf16", action="store_true",
                   help="mixed-precision GAN step (bf16 conv compute, fp32 parameters, "
                        "optimizer state, EMA, losses and mel DSP)")
    s.add_argument("--on-divergence", default="halt", choices=["halt", "warn"],
                   help="the GAN-collapse watchdog's action: halt checkpoints the diverged "
                        "state beside a generator_last_healthy artifact and stops; warn "
                        "prints once and goes on")
    s.add_argument("--ema-decay", type=float, default=0.0,
                   help="EMA of the generator's parameters (0 = off); saved as "
                        "generator_ema.npz beside each checkpoint's generator.npz")
    s.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' fails when no GPU is visible")
    _add_distributed_args(s)
    s.set_defaults(fn=cmd_train_vocoder)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
