import sys

from repro_torch.serve.cli import main

sys.exit(main())
