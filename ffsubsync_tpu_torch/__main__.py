# -*- coding: utf-8 -*-
import sys

from ffsubsync_tpu_torch.sync import main

if __name__ == "__main__":
    sys.exit(main())
