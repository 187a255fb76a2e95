import sys

from mumemto_tpu_torch.cli import main

sys.exit(main())
