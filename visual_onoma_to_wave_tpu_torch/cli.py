"""Command line of the PyTorch port: `synthesize`, `serve` and `preprocess`.

    python -m visual_onoma_to_wave_tpu_torch.cli synthesize \\
        examples/checkpoints/demo/config.json \\
        --acoustic examples/checkpoints/demo/torch/acoustic.npz \\
        --vocoder examples/checkpoints/demo/torch/vocoder.npz \\
        --text パンパン --audiotype drum --out out.wav

    python -m visual_onoma_to_wave_tpu_torch.cli preprocess <config> [--device cpu]

Weights are the `.npz` trees written by `examples/export_demo_for_torch.py`;
configs load through `config.load_config` (JSON, YAML or the reference's
three-YAML directory).
"""
from __future__ import annotations

import argparse
import json


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


def cmd_preprocess(args) -> None:
    from visual_onoma_to_wave_tpu_torch.config import load_config
    from visual_onoma_to_wave_tpu_torch.data.preprocess import Preprocessor

    cfg = load_config(args.config)
    result = Preprocessor(cfg, num_workers=args.num_workers, save_audio=args.save_audio,
                          device=args.device).build()
    print(json.dumps(result))


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

    s = sub.add_parser("preprocess", help="formatted corpus -> training features (03_preprocess)")
    s.add_argument("config")
    s.add_argument("--num-workers", type=int, default=None, help="host worker processes")
    s.add_argument("--save-audio", action="store_true",
                   help="also save mel-aligned trimmed waveforms under audio/")
    s.add_argument("--device", default="cuda",
                   help="torch device of the feature pass; 'cuda' fails when no GPU is visible")
    s.set_defaults(fn=cmd_preprocess)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
