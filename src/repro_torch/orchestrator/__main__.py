import sys

from repro_torch.orchestrator.cli import main

if __name__ == "__main__":
    sys.exit(main())
