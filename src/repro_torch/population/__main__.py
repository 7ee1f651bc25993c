from repro_torch.population.cli import main

raise SystemExit(main())
