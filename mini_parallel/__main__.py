import sys

from mini_parallel.cli import main

sys.exit(main())
