import sys

from fedrann_tpu_torch.cli import main

sys.exit(main())
