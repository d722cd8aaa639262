# -*- coding: utf-8 -*-
"""The neural VAD's trainer and evaluation harnesses, run as modules:

    python -m ffsubsync_tpu_torch.scripts.train_neural_vad --help
    python -m ffsubsync_tpu_torch.scripts.eval_neural_vad --help
    python -m ffsubsync_tpu_torch.scripts.eval_vad_agreement --help
"""
