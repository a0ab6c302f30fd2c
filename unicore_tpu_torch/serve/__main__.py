import sys

from unicore_tpu_torch.serve.cli import main

sys.exit(main())
