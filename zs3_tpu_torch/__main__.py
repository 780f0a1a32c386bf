import sys

from zs3_tpu_torch.cli import main

sys.exit(main())
