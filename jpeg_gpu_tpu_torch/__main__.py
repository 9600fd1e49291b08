import sys

from jpeg_gpu_tpu_torch.cli import main

sys.exit(main())
