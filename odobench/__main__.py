import sys

from odobench.run import main

sys.exit(main())
