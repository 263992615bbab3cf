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
    python -m visual_onoma_to_wave_tpu_torch.cli demo <config> [--acoustic acoustic.npz |
        --restore-step N] [--vocoder vocoder.npz] [--host 127.0.0.1] [--port 7860]

Weights are `.npz` trees: those written by `examples/export_demo_for_torch.py`,
or a training checkpoint's `<ckpt>/<step>/acoustic.npz`. Configs load through
`config.load_config` (JSON, YAML or the reference's three-YAML directory).
Every command that computes runs on `cuda` unless `--device cpu` is given.
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


def cmd_serve(args) -> None:
    from visual_onoma_to_wave_tpu_torch.config import load_config
    from visual_onoma_to_wave_tpu_torch.serve import BatchingServer
    from visual_onoma_to_wave_tpu_torch.synthesis import Synthesizer

    cfg = load_config(args.config)
    synth = Synthesizer.from_checkpoint(cfg, acoustic=args.acoustic, vocoder=args.vocoder,
                                        device=args.device)
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


def _trainer(args):
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
    print(json.dumps(_trainer(args).evaluate(metrics=args.metrics)))


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

    s = sub.add_parser("serve", help="JSON API with micro-batching")
    common(s)
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
    s.set_defaults(fn=cmd_train)

    s = sub.add_parser("evaluate", help="validation losses (evaluate.py)")
    trained(s, "the waveform metrics under --metrics (needs preprocess --save-audio)")
    s.add_argument("--metrics", action="store_true",
                   help="also teacher-forced mel_l1 and MCD, free-running DTW-MCD (dB)")
    s.set_defaults(fn=cmd_evaluate)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
